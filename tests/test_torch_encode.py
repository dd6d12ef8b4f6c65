"""The witness's encoding, ``fo.encode_witness`` and its batched form
``fo.encode_witness_many``, on the CPU (``to_mont``'s plain version):

- it equals ``fo.encode_mont`` limb for limb on random Fr elements, on 0, 1
  and m - 1, on inputs at or above m (m, 2^256 - 1, 2^300) and on negative
  ones (-1, -m - 5), at lengths 1, 2^5 and 2^10: a witness of canonical
  values skips the reduction, one with any value outside [0, m) takes it;
- the batched form equals the stack of the singles at B = 3;
- ``kernels.LANES["witness_encode"]`` counts one call of n lanes for a
  prove at 2^5 (the golden proof's bytes, on the device transcript, the
  host loop and the sharded route) and one of B n for ``prove_many`` at
  B = 2.
"""

import collections
import random
import types

import pytest
import torch
from torch_golden import GOLDEN, instance, keys, reuse_openings

from spartan_tpu_torch import kernels
from spartan_tpu_torch.ops import field as fo
from spartan_tpu_torch.ops.field import FR, WITNESS_ENCODE
from spartan_tpu_torch.parallel import sharded
from spartan_tpu_torch.protocol import batched
from spartan_tpu_torch.protocol.argument import MLArgumentForR1CS

torch.set_num_threads(1)

M = FR.modulus
EDGES = {
    "0, 1, m - 1": [0, 1, M - 1],
    "m, 2^256 - 1, 2^300": [M, (1 << 256) - 1, 1 << 300],
    "-1, -m - 5": [-1, -M - 5],
}


def _random(n: int, seed: int) -> list:
    rng = random.Random(seed)
    return [rng.randrange(M) for _ in range(n)]


@pytest.mark.parametrize("n", [1, 1 << 5, 1 << 10])
def test_random_elements_match_encode_mont(n):
    xs = _random(n, n)
    assert torch.equal(fo.encode_witness(FR, xs), fo.encode_mont(FR, xs))


@pytest.mark.parametrize("n", [1 << 5, 1 << 10])
@pytest.mark.parametrize("edge", sorted(EDGES))
def test_edge_values_match_encode_mont(edge, n):
    """The values at the head, in the middle and at the tail of a witness,
    so they meet every limb position of the layout's lanes."""
    xs = _random(n, 7 * n)
    vals = EDGES[edge]
    for at in (0, n // 2, n - len(vals)):
        xs[at : at + len(vals)] = vals
    got = fo.encode_witness(FR, xs)
    assert torch.equal(got, fo.encode_mont(FR, xs))
    assert fo.decode_mont(FR, got[:, :len(vals)]) == [x % M for x in vals]


@pytest.mark.parametrize("n", [1, 1 << 5])
def test_batched_form_is_the_stack_of_singles(n):
    xss = [_random(n, 100 + b) for b in range(3)]
    xss[1][0] = -1
    got = fo.encode_witness_many(FR, xss)
    assert got.shape == (3, FR.nlimb, n) and got.is_contiguous()
    assert torch.equal(got, torch.stack([fo.encode_witness(FR, xs) for xs in xss]))


def test_witnesses_of_two_lengths_raise():
    with pytest.raises(ValueError, match="one length"):
        fo.encode_witness_many(FR, [[1, 2], [3]])


def test_each_call_counts_its_lanes():
    kernels.reset_counts()
    fo.encode_witness(FR, [1, 2, 3])
    fo.encode_witness_many(FR, [[1, 2], [3, 4]])
    fo.encode_mont(FR, [5])  # a challenge's codec: not counted
    assert kernels.LANES[WITNESS_ENCODE] == collections.Counter({(3,): 1, (4,): 1})


@pytest.mark.parametrize("route", ["device transcript", "host loop", "sharded D = 2"])
def test_prove_encodes_once_and_gives_the_golden_proof(route, monkeypatch):
    reuse_openings(monkeypatch)
    monkeypatch.setenv("SPARTAN_DEVICE_FS", "0" if route == "host loop" else "1")
    mesh = sharded.make_mesh(devices=["cpu"] * 2) if route.startswith("sharded") else None
    pk, v, w = instance()
    pp, _vp = keys()
    kernels.reset_counts()
    proof = MLArgumentForR1CS.prove(pk, v, w, pp, mesh=mesh)
    assert proof.serialize() == GOLDEN.read_bytes()
    assert kernels.LANES[WITNESS_ENCODE] == collections.Counter({(len(v) + len(w),): 1})


def test_prove_many_encodes_the_batch_once(monkeypatch):
    """prove_many's "Batch Prove 0: encode z" is one call of B n lanes,
    whose table the commits are given: the stack of each witness's
    encoding. The commits stand in, and stop the prove there."""
    pk, v, w = instance()
    w2 = [(x + 1) % M for x in w]
    seen = []

    class Stop(Exception):
        pass

    def commit_many(pp, z):
        seen.append(z)
        raise Stop

    monkeypatch.setattr(batched, "commit_many", commit_many)
    kernels.reset_counts()
    with pytest.raises(Stop):
        batched.prove_many(pk, [(v, w), (v, w2)], types.SimpleNamespace(device=torch.device("cpu")))
    n = len(v) + len(w)
    assert kernels.LANES[WITNESS_ENCODE] == collections.Counter({(2 * n,): 1})
    want = torch.stack([fo.encode_mont(FR, v + ww) for ww in (w, w2)])
    assert torch.equal(seen[0], want)
