"""Port field layer (spartan_tpu_torch.ops.field) vs the JAX package.

Same seeded numpy inputs through spartan_tpu.ops.field (its jnp path, as the
JAX tests run it on the CPU) and through the port's wrappers (their plain
versions on CPU tensors). Field arithmetic is exact: tolerance zero.
"""

import numpy as np
import pytest
import torch

from spartan_tpu.host import field as hf
from spartan_tpu.ops import field as jf
from spartan_tpu_torch.ops import field as tf

torch.set_num_threads(1)  # small int64 tensors: one intra-op thread is fastest

SPECS = {"fr": (jf.FR, tf.FR), "fp": (jf.FP, tf.FP)}


def _values(m: int, n: int, seed: int):
    """0, 1, m - 1, then seeded random values below m."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 63, size=(n, 7), dtype=np.int64)
    vals = [sum(int(x) << (63 * i) for i, x in enumerate(row)) % m for row in words]
    return [0, 1, m - 1] + vals


@pytest.mark.parametrize("name", ["fr", "fp"])
@pytest.mark.parametrize("op", ["add", "sub", "mont_mul"])
def test_binary_ops_match_jax(name, op):
    jspec, tspec = SPECS[name]
    m = tspec.modulus
    xs = _values(m, 29, 1)
    ys = list(reversed(_values(m, 29, 2)))  # pairs (0, m-1), ... at the ends
    want = jf.decode_ints(jspec, getattr(jf, op)(jspec, jf.encode_ints(jspec, xs), jf.encode_ints(jspec, ys)))
    got = tf.decode_ints(tspec, getattr(tf, op)(tspec, tf.encode_ints(tspec, xs), tf.encode_ints(tspec, ys)))
    assert got == want
    oracle = {"add": lambda x, y: (x + y) % m, "sub": lambda x, y: (x - y) % m,
              "mont_mul": lambda x, y: x * y * tspec.r_inv % m}[op]
    assert got == [oracle(x, y) for x, y in zip(xs, ys)]


@pytest.mark.parametrize("name", ["fr", "fp"])
def test_inverse_and_mont_roundtrip_match_jax(name):
    jspec, tspec = SPECS[name]
    m = tspec.modulus
    xs = _values(m, 10, 3)
    want = jf.decode_mont(jspec, jf.inv(jspec, jf.encode_mont(jspec, xs)))
    got = tf.decode_mont(tspec, tf.inv(tspec, tf.encode_mont(tspec, xs)))
    assert got == want == [pow(x, m - 2, m) for x in xs]
    a = tf.encode_ints(tspec, xs)
    assert tf.decode_ints(tspec, tf.from_mont(tspec, tf.to_mont(tspec, a))) == xs
    assert tf.decode_mont(tspec, tf.to_mont(tspec, a)) == xs
    assert tf.decode_ints(tspec, tf.neg(tspec, a)) == [(-x) % m for x in xs]


@pytest.mark.parametrize("name", ["fr", "fp"])
def test_repack16_carries_jax_montgomery_limbs(name):
    """16-bit JAX limbs pack into 32-bit port limbs with the same R."""
    jspec, tspec = SPECS[name]
    xs = _values(tspec.modulus, 6, 4)
    jax_mont = np.asarray(jf.encode_mont(jspec, xs))
    assert torch.equal(tf.repack16(jax_mont), tf.encode_mont(tspec, xs))


@pytest.mark.parametrize("name", ["fr", "fp"])
def test_reduce_wide_matches_jax_and_ints(name):
    jspec, tspec = SPECS[name]
    rng = np.random.default_rng(5)
    wide = rng.integers(0, 1 << 40, size=(tspec.nsub + 3, 12), dtype=np.int64)
    want = [sum(int(wide[j, i]) << (16 * j) for j in range(wide.shape[0])) % tspec.modulus
            for i in range(wide.shape[1])]
    assert tf.decode_ints(tspec, tf.reduce_wide(tspec, torch.from_numpy(wide))) == want
    # the JAX reduction takes uint32 limbs: the same value below 2^32 per limb
    small = (wide & 0xFFFFFFF).astype(np.uint32)
    want_small = jf.decode_ints(jspec, jf.reduce_wide(jspec, small))
    got_small = tf.decode_ints(tspec, tf.reduce_wide(tspec, torch.from_numpy(small.astype(np.int64))))
    assert got_small == want_small


def test_sum_mod_matches_ints():
    xs = _values(hf.R, 300, 6)
    got = tf.decode_ints(tf.FR, tf.sum_mod(tf.encode_ints(tf.FR, xs)))
    assert got == [sum(xs) % hf.R]


def test_broadcast_scalar_operand():
    xs = _values(hf.R, 8, 7)
    s = tf.encode_mont(tf.FR, [12345])
    got = tf.decode_mont(tf.FR, tf.mont_mul(tf.FR, tf.encode_mont(tf.FR, xs), s))
    assert got == [x * 12345 % hf.R for x in xs]


def _oracle(op, spec):
    m = spec.modulus
    return {"add": lambda x, y: (x + y) % m, "sub": lambda x, y: (x - y) % m,
            "mont_mul": lambda x, y: x * y * spec.r_inv % m}[op]


@pytest.mark.parametrize("name", ["fr", "fp"])
@pytest.mark.parametrize("op", ["add", "sub", "mont_mul"])
@pytest.mark.parametrize("shape", [(1,), (5,), (3, 4), (2, 1, 3)])
def test_batch_shapes_match_ints(name, op, shape):
    """(K, *shape) batches keep their shape; the second operand broadcasts
    along the last axis."""
    tspec = SPECS[name][1]
    n = int(np.prod(shape))
    xs = _values(tspec.modulus, n, 8)[:n]
    ys = _values(tspec.modulus, shape[-1], 9)[: shape[-1]]
    a = tf.encode_ints(tspec, xs).reshape((tspec.nlimb,) + shape)
    b = tf.encode_ints(tspec, ys).reshape((tspec.nlimb,) + (1,) * (len(shape) - 1) + shape[-1:])
    out = getattr(tf, op)(tspec, a, b)
    assert out.shape == a.shape and out.dtype == torch.int32
    f = _oracle(op, tspec)
    assert tf.decode_ints(tspec, out.reshape(tspec.nlimb, -1)) == [
        f(x, ys[i % shape[-1]]) for i, x in enumerate(xs)]


@pytest.mark.parametrize("name", ["fr", "fp"])
@pytest.mark.parametrize("op", ["add", "sub", "mont_mul"])
def test_carry_boundary_values_match_ints(name, op):
    """Values whose limbs are all ones or all zeros, and m - 2^j: every carry
    and borrow runs the full width."""
    tspec = SPECS[name][1]
    m = tspec.modulus
    edge = [(1 << (32 * k)) - 1 for k in range(1, tspec.nlimb)]
    edge += [m - (1 << j) for j in range(0, m.bit_length() - 1, 37)]
    edge += [1 << (32 * k) for k in range(tspec.nlimb)]
    xs = [x % m for x in edge]
    ys = list(reversed(xs))
    out = getattr(tf, op)(tspec, tf.encode_ints(tspec, xs), tf.encode_ints(tspec, ys))
    f = _oracle(op, tspec)
    assert tf.decode_ints(tspec, out) == [f(x, y) for x, y in zip(xs, ys)]


@pytest.mark.parametrize("name", ["fr", "fp"])
@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 13])
def test_batch_inv_odd_lengths_and_zero_lanes(name, n):
    """The product tree pads odd levels; zero lanes invert to zero."""
    tspec = SPECS[name][1]
    m = tspec.modulus
    xs = _values(m, n, 10 + n)[3 : 3 + n]
    xs[n // 2] = 0
    got = tf.decode_mont(tspec, tf.inv(tspec, tf.encode_mont(tspec, xs)))
    assert got == [pow(x, m - 2, m) for x in xs]


@pytest.mark.parametrize("e", [0, 1, 2, 3, 17, (1 << 64) + 1])
def test_pow_const_matches_ints(e):
    xs = _values(hf.R, 4, 11)
    got = tf.decode_mont(tf.FR, tf.pow_const(tf.FR, tf.encode_mont(tf.FR, xs), e))
    assert got == [pow(x, e, hf.R) for x in xs]


@pytest.mark.parametrize("nlimb", [8, 12])
def test_limb_codecs_round_trip(nlimb):
    """Top bits set (negative int32 limbs) survive both directions."""
    xs = [0, 1, (1 << (32 * nlimb)) - 1, 0x80000000 << (32 * (nlimb - 1)), 0xDEADBEEF << 32]
    limbs = tf.ints_to_limbs(xs, nlimb)
    assert limbs.shape == (nlimb, len(xs)) and limbs.dtype == np.int32
    assert tf.limbs_to_ints(limbs) == xs
    assert tf.limbs_to_ints(torch.from_numpy(limbs)) == xs


@pytest.mark.parametrize("name", ["fr", "fp"])
@pytest.mark.parametrize("bits", [16, 32, 46])
def test_reduce_wide_large_limbs(name, bits):
    """Accumulator limbs up to just below 2^47, as long segment sums give."""
    tspec = SPECS[name][1]
    rng = np.random.default_rng(bits)
    wide = rng.integers(0, 1 << bits, size=(tspec.nsub + 2, 6), dtype=np.int64)
    wide[:, 0] = (1 << bits) - 1
    want = [sum(int(wide[j, i]) << (16 * j) for j in range(wide.shape[0])) % tspec.modulus
            for i in range(wide.shape[1])]
    assert tf.decode_ints(tspec, tf.reduce_wide(tspec, torch.from_numpy(wide))) == want


def test_batch_inv_plain_root_matches_jax_inv_with_zero_lanes():
    """batch_inv over the plain product and the plain Fermat root (the CPU
    path of every Fp inversion) against the JAX package's field.inv."""
    from functools import partial

    m = tf.FP.modulus
    xs = [0] + _values(m, 5, 4)[1:] + [0]
    want = jf.decode_mont(jf.FP, jf.inv(jf.FP, jf.encode_mont(jf.FP, xs)))
    got = tf.batch_inv(tf.FP, tf.encode_mont(tf.FP, xs), partial(tf.mont_mul_plain, tf.FP),
                       partial(tf.fermat_inv_plain, tf.FP))
    assert tf.decode_mont(tf.FP, got) == want == [pow(x, m - 2, m) for x in xs]


@pytest.mark.parametrize("name", ["fr", "fp"])
def test_fermat_inv_is_plain_on_cpu_and_never_falls_back_off_it(name):
    _jspec, tspec = SPECS[name]
    m = tspec.modulus
    xs = _values(m, 3, 5)
    a = tf.encode_mont(tspec, xs)
    got = tf.fermat_inv(tspec, a)
    assert torch.equal(got, tf.fermat_inv_plain(tspec, a))
    assert tf.decode_mont(tspec, got) == [pow(x, m - 2, m) for x in xs]
    with pytest.raises(ValueError, match="kernel needs CUDA"):
        tf.fermat_inv(tspec, a.to("meta"))
