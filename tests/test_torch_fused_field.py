"""The port's fused K1 and K2 functions, plain versions, against the JAX
package, limb for limb (the tolerance is zero):

- ``curve.normalize`` (Jacobian -> affine encoding, ``normalize_plain`` on
  the CPU) against ``spartan_tpu/commitment/scheme.py`` ``_normalize_g1`` /
  ``_normalize_g2`` over ``spartan_tpu/ops/curve.py:270``, at 5 lanes, one
  of them infinity;
- ``mle.eq_table`` and ``mle.eq_suffix_tables_mont`` against
  ``spartan_tpu/ops/mle.py:89`` and ``:123`` at nv = 1..5;
- ``commitment.scheme._quotients_and_eval`` against
  ``spartan_tpu/commitment/scheme.py:175`` at nv = 1..6;

and each wrapper raising, not falling back, for a tensor that is neither on
the CPU nor on a card. The kernels themselves are held against these plain
versions in ``test_torch_csrc_host.py`` (host-compiled) and in
``chip_smoke.py`` (on the card).
"""

import random

import numpy as np
import pytest
import torch

from spartan_tpu.commitment import scheme as jscheme
from spartan_tpu.host import curve as hc
from spartan_tpu.host import field as hf
from spartan_tpu.ops import curve as jcv
from spartan_tpu.ops import field as jf
from spartan_tpu.ops import mle as jmle
from spartan_tpu_torch.commitment import scheme as tscheme
from spartan_tpu_torch.ops import curve as tcv
from spartan_tpu_torch.ops import field as tf
from spartan_tpu_torch.ops import mle as tmle

torch.set_num_threads(1)  # small int64 tensors: one intra-op thread is fastest

GROUPS = {
    "g1": (hc.G1, hf.G1_GEN, jcv.G1_FIELD, jcv.g1_encode, tcv.g1_encode, jscheme._normalize_g1),
    "g2": (hc.G2, hf.G2_GEN, jcv.G2_FIELD, jcv.g2_encode, tcv.g2_encode, jscheme._normalize_g2),
}


def _jax_numpy(jp):
    if isinstance(jp.x, tuple):
        return tuple(tuple(np.asarray(c) for c in coord) for coord in jp)
    return tuple(np.asarray(c) for c in jp)


def _fr(n: int, seed: int) -> list:
    """n seeded Fr values from numpy words."""
    words = np.random.default_rng(seed).integers(0, 1 << 62, size=(n, 5), dtype=np.int64)
    return [sum(int(x) << (62 * i) for i, x in enumerate(row)) % hf.R for row in words]


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_normalize_matches_jax(group):
    """5 Jacobian lanes (doubled affine points, so z != 1), lane 3 the
    point at infinity: the port's affine encoding equals the JAX package's
    limb for limb, and decodes to the host's doubles."""
    ops, gen, jfield, jenc, tenc, jnorm = GROUPS[group]
    ks = np.random.default_rng(5).integers(1, 1 << 62, size=5)
    pts = [ops.mul(gen, int(k)) for k in ks]
    pts[3] = None
    jp = jcv.double(jfield, jenc(pts))
    tp = tcv.from_jax(_jax_numpy(jp), group)
    got = tcv.normalize(tp)
    assert torch.equal(got.data, tcv.normalize_plain(tp).data)
    assert torch.equal(got.data, tcv.from_jax(_jax_numpy(jnorm(jp)), group).data)
    assert torch.equal(got.data[..., 3], torch.zeros_like(got.data[..., 3]))
    dec = tcv.g1_decode if group == "g1" else tcv.g2_decode
    assert dec(got) == [None if p is None else ops.double(p) for p in pts]
    assert torch.equal(got.data, tenc(dec(got)).data)


@pytest.mark.parametrize("nv", [1, 2, 3, 4, 5])
def test_eq_tables_match_jax(nv):
    pt = _fr(nv, 30 + nv)
    jp, tp = jf.encode_mont(jf.FR, pt), tf.encode_mont(tf.FR, pt)
    full = tmle.eq_table(tp[None])[0]
    assert torch.equal(full, tf.repack16(np.asarray(jmle.eq_table(jp))))
    suffix = [t[0] for t in tmle.eq_suffix_tables_mont(tp[None])]
    want = jmle.eq_suffix_tables_mont(jp)
    assert len(suffix) == len(want) == nv + 1
    assert all(torch.equal(a, tf.repack16(np.asarray(b))) for a, b in zip(suffix, want))
    assert torch.equal(suffix[0], full)  # table 0 of the suffix set is eq_table


@pytest.mark.parametrize("nv", [1, 2, 3, 4, 5, 6])
def test_quotients_and_eval_match_jax(nv):
    poly, pt = _fr(1 << nv, 40 + nv), _fr(nv, 50 + nv)
    qcat, ev = tscheme._quotients_and_eval(tf.encode_mont(tf.FR, poly), tf.encode_mont(tf.FR, pt))
    jq, je = jscheme._quotients_and_eval(jf.encode_mont(jf.FR, poly), jf.encode_mont(jf.FR, pt))
    assert qcat.shape == (8, (1 << nv) - 1) and ev.shape == (8, 1)
    assert torch.equal(qcat, tf.repack16(np.asarray(jq)))
    assert torch.equal(ev, tf.repack16(np.asarray(je)))
    # the evaluation is the multilinear extension at the point, variable 0 first
    want = 0
    for b, v in enumerate(poly):
        w = v
        for i, p in enumerate(pt):
            w = w * (p if b >> i & 1 else 1 - p) % hf.R
        want += w
    assert tf.decode_ints(tf.FR, ev) == [want % hf.R]


@pytest.mark.parametrize("which", ["normalize", "eq_table", "eq_suffix", "quotients"])
def test_fused_wrappers_never_fall_back_off_cpu(which):
    """A tensor that is not on the CPU goes to the kernel path, which only
    takes CUDA tensors: it raises instead of running the plain version."""
    meta = torch.zeros((8, 4), dtype=torch.int32, device="meta")
    call = {
        "normalize": lambda: tcv.normalize(tcv.infinity("g2", 4, device="meta")),
        "eq_table": lambda: tmle.eq_table(meta[None]),
        "eq_suffix": lambda: tmle.eq_suffix_tables_mont(meta[None]),
        "quotients": lambda: tscheme._quotients_and_eval(torch.zeros((8, 16), dtype=torch.int32, device="meta"),
                                                          meta),
    }[which]
    with pytest.raises(ValueError, match="kernel needs one CUDA device"):
        call()


def test_g1_normalize_host_points_round_trip():
    """normalize of host points in Jacobian form with random Z equals their
    affine encoding (an independent check of the plain path's formulas)."""
    rng = random.Random(8)
    pts = [hc.G1.mul(hf.G1_GEN, rng.randrange(1, hf.R)) for _ in range(3)] + [None]
    enc = tcv.g1_encode(pts)
    lam = tf.encode_mont(tf.FP, [rng.randrange(1, hf.P) for _ in range(4)])
    lam2 = tf.mont_mul_plain(tf.FP, lam, lam)
    jac = torch.stack([tf.mont_mul_plain(tf.FP, enc.data[0], lam2),
                       tf.mont_mul_plain(tf.FP, enc.data[1], tf.mont_mul_plain(tf.FP, lam2, lam)),
                       tf.mont_mul_plain(tf.FP, enc.data[2], lam)])
    assert torch.equal(tcv.normalize(tcv.PointBatch(jac, "g1")).data, enc.data)
