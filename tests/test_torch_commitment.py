"""Port polynomial commitment vs the JAX package's layout and the host oracle.

- pp_from_numpy carries JAX limb arrays (cv.g1_encode/g2_encode) over to
  the port unchanged in value;
- port keygen entries equal g^{eq(t[i..], b)} and h^{eq(t[i..], b)} computed
  on the host from the same sample_fr() stream;
- commit / open / verify round trip, and a wrong evaluation is rejected.
"""

import random

import numpy as np
import pytest
import torch

from spartan_tpu.host import curve as hc
from spartan_tpu.host import field as hf
from spartan_tpu.ops import curve as jcv
from spartan_tpu_torch.commitment import commit, keygen, open_poly, pp_from_numpy, verify
from spartan_tpu_torch.ops import curve as cv
from spartan_tpu_torch.ops import field as fo

torch.set_num_threads(1)  # small int64 tensors: one intra-op thread is fastest

NV = 3


class SeededFr:
    def __init__(self, seed):
        self._r = random.Random(seed)

    def sample_fr(self):
        return self._r.randrange(hf.R)


def _eq(t, b_bits):
    out = 1
    for ti, bi in zip(t, b_bits):
        out = out * (ti * bi + (1 - ti) * (1 - bi)) % hf.R
    return out


@pytest.fixture(scope="module")
def keys():
    return keygen(NV, SeededFr(21), "cpu")


def test_pp_from_numpy_round_trip():
    g1 = [hc.G1.mul(hf.G1_GEN, k) for k in (3, 5, 7, 11)]
    g2 = [hc.G2.mul(hf.G2_GEN, k) for k in (3, 5, 7, 11)]
    g1[2] = None
    as_np = lambda pb: jax_tree_numpy(pb)
    pp = pp_from_numpy(
        2,
        powers_of_g=[as_np(jcv.g1_encode(g1)), as_np(jcv.g1_encode(g1[:2]))],
        powers_of_h=[as_np(jcv.g2_encode(g2)), as_np(jcv.g2_encode(g2[:2]))],
        g=g1[0], h=g2[0],
        powers_of_h_comb=[as_np(jcv.g2_encode(g2[:2])), as_np(jcv.g2_encode(g2[:1]))],
    )
    assert cv.g1_decode(pp.powers_of_g[0]) == g1
    assert cv.g2_decode(pp.powers_of_h[0]) == g2
    assert cv.g2_decode(pp.powers_of_h_comb[1]) == g2[:1]
    assert torch.equal(pp.powers_of_g[1].data, cv.g1_encode(g1[:2]).data)


def jax_tree_numpy(pb):
    if isinstance(pb.x, tuple):
        return tuple(tuple(np.asarray(c) for c in coord) for coord in pb)
    return tuple(np.asarray(c) for c in pb)


def test_keygen_matches_host_hypercubes(keys):
    pp, vp, t = keys
    stream = SeededFr(21)
    g = hc.G1.mul(hf.G1_GEN, stream.sample_fr())
    h = hc.G2.mul(hf.G2_GEN, stream.sample_fr())
    assert (pp.g, pp.h, vp.g, vp.h) == (g, h, g, h)
    assert t == [stream.sample_fr() for _ in range(NV)]
    assert vp.g_mask_random == [hc.G1.mul(g, ti) for ti in t]
    for i in range(NV):
        size = 1 << (NV - i)
        eqs = [_eq(t[i:], [(b >> j) & 1 for j in range(NV - i)]) for b in range(size)]
        assert cv.g1_decode(pp.powers_of_g[i]) == [hc.G1.mul(g, e) for e in eqs]
        hs = [hc.G2.mul(h, e) for e in eqs]
        assert cv.g2_decode(pp.powers_of_h[i]) == hs
        assert cv.g2_decode(pp.powers_of_h_comb[i]) == [
            hc.G2.add(hs[2 * j], hs[2 * j + 1]) for j in range(size // 2)
        ]


def test_commit_open_verify(keys):
    pp, vp, _t = keys
    rng = np.random.default_rng(9)
    vals = [int(x) % hf.R for x in rng.integers(0, 1 << 62, size=1 << NV, dtype=np.int64)]
    poly = fo.encode_mont(fo.FR, vals)
    com = commit(pp, poly)
    assert com.g_product == hc.G1.msm(cv.g1_decode(pp.powers_of_g[0]), vals)
    point = [int(x) for x in rng.integers(0, 1 << 62, size=NV, dtype=np.int64)]
    ev, proof, q_tables = open_poly(pp, poly, point)
    table = list(vals)
    for r in point:
        table = [(table[2 * b] + r * (table[2 * b + 1] - table[2 * b])) % hf.R for b in range(len(table) // 2)]
    assert ev == table[0]
    assert [q.shape[1] for q in q_tables] == [4, 2, 1]
    assert verify(vp, com, point, ev, proof)
    assert not verify(vp, com, point, (ev + 1) % hf.R, proof)


def test_native_pairing_product_matches_jax_package():
    from spartan_tpu.host import pairing as jhp
    from spartan_tpu_torch.host import pairing as thp

    rng = random.Random(6)
    a, b = rng.randrange(1, hf.R), rng.randrange(1, hf.R)
    pairs = [(hc.G1.mul(hf.G1_GEN, a), hc.G2.mul(hf.G2_GEN, b)),
             (hc.G1.neg(hf.G1_GEN), hc.G2.mul(hf.G2_GEN, a * b)), (None, hf.G2_GEN)]
    got = thp.product_of_pairings(pairs)
    assert got == jhp.product_of_pairings(pairs)
    # e(aG, bH) e(-G, abH) = 1: bilinearity, in the cubed GT the port returns
    assert thp.product_of_pairings(pairs[:2]) == thp.pairing(None, hf.G2_GEN)
