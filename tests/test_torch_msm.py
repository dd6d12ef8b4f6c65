"""Port MSM (spartan_tpu_torch.ops.msm) vs the host oracle hc.G1/G2.msm.

Scalars come from a seeded numpy generator, with the edge scalars 0, 1 and
r - 1, a repeated point and the point at infinity among the bases. Group
arithmetic is exact: results must be equal affine points.
"""

import numpy as np
import pytest
import torch

from spartan_tpu.host import curve as hc
from spartan_tpu.host import field as hf
from spartan_tpu_torch.ops import curve as cv
from spartan_tpu_torch.ops import field as fo
from spartan_tpu_torch.ops import msm

torch.set_num_threads(1)  # small int64 tensors: one intra-op thread is fastest


def _scalars(n: int, seed: int):
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 62, size=(n, 5), dtype=np.int64)
    out = [sum(int(x) << (62 * i) for i, x in enumerate(row)) % hf.R for row in words]
    out[:3] = [0, 1, hf.R - 1]
    return out


def _bases(ops, gen, n: int, seed: int):
    """n distinct affine points k_i * B (host adds), then one repeat and
    one infinity; also returns the multipliers k_i (None at infinity)."""
    rng = np.random.default_rng(seed)
    b = ops.mul(gen, int(rng.integers(2, 1 << 60)))
    pts, ks = [b], [1]
    step = ops.double(b)
    for i in range(1, n):
        pts.append(ops.add(pts[-1], step if i % 2 else b))
        ks.append(ks[-1] + (2 if i % 2 else 1))
    pts[4], ks[4] = pts[5], ks[5]
    pts[6], ks[6] = None, None
    return b, pts, ks


def _host_msm_via_multiplier(ops, base, ks, scalars):
    """sum s_i k_i B as one scalar multiplication (the bases are k_i B)."""
    tot = sum(s * k for s, k in zip(scalars, ks) if k is not None) % hf.R
    return ops.mul(base, tot)


def test_g1_msm_300_points_matches_host():
    base, pts, ks = _bases(hc.G1, hf.G1_GEN, 300, 1)
    sc = _scalars(300, 2)
    got = cv.g1_decode(msm.msm(cv.g1_encode(pts), fo.encode_ints(fo.FR, sc)))[0]
    assert got == _host_msm_via_multiplier(hc.G1, base, ks, sc)


@pytest.mark.parametrize("c", [4, 8])
def test_g1_msm_window_widths_agree(c):
    base, pts, ks = _bases(hc.G1, hf.G1_GEN, 64, 3)
    sc = _scalars(64, 4)
    got = cv.g1_decode(msm.msm(cv.g1_encode(pts), fo.encode_ints(fo.FR, sc), c))[0]
    assert got == hc.G1.msm(pts, sc)


def test_g2_msm_many_matches_host_msm():
    sizes = [32, 16, 8, 4, 2, 1, 1]
    n = sum(sizes)
    base, pts, ks = _bases(hc.G2, hf.G2_GEN, n, 5)
    sc = _scalars(n, 6)
    got = cv.g2_decode(msm.msm_many(cv.g2_encode(pts), sizes, fo.encode_ints(fo.FR, sc), 4))
    off, want = 0, []
    for s in sizes:
        want.append(_host_msm_via_multiplier(hc.G2, base, ks[off:off + s], sc[off:off + s]))
        off += s
    assert got == want
    # one level against the oracle's own MSM
    assert got[2] == hc.G2.msm(pts[48:56], sc[48:56])


@pytest.mark.parametrize("c", [1, 2, 4, 8, 16])
def test_signed_digits_reconstruct_scalars(c):
    sc = _scalars(40, 7)
    d = msm.signed_digits(fo.encode_ints(fo.FR, sc), c)
    half = 1 << (c - 1)
    assert int(d[:-1].min()) >= -half and int(d[:-1].max()) <= half - 1
    assert int(d[-1].min()) >= 0 and int(d[-1].max()) <= half
    for j, s in enumerate(sc):
        assert sum(int(d[w, j]) << (c * w) for w in range(d.shape[0])) == s


@pytest.mark.parametrize("c", [1, 2, 4, 8, 16])
def test_unsigned_digits_reconstruct_scalars(c):
    sc = _scalars(20, 8)
    d = msm.digits_from_limbs(fo.encode_ints(fo.FR, sc), c)
    assert d.shape == (256 // c, 20)
    assert int(d.min()) >= 0 and int(d.max()) < 1 << c
    for j, s in enumerate(sc):
        assert sum(int(d[w, j]) << (c * w) for w in range(d.shape[0])) == s


def test_fixed_base_msm_matches_host():
    g = hc.G1.mul(hf.G1_GEN, 987654321)
    table = cv.normalize(msm.fixed_base_table_device(g, hc.G1, cv.g1_encode, 4, "cpu"))
    sc = _scalars(6, 8)
    got = cv.g1_decode(msm.fixed_base_msm(table, fo.encode_ints(fo.FR, sc), 4))
    assert got == [hc.G1.mul(g, s) for s in sc]
