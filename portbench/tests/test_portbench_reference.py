"""The plain reference on the CPU: held against the JAX package's 2^5 proof
(``tests/fixtures/proof_2e5_seed3.bin``), its trapdoor identities, its
control, and its time at 2^10 .. 2^12 (printed, for the extrapolation to
2^16 in PERF.md).

    python -m pytest portbench/tests -q
"""

import math
import sys
import time
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import generator  # noqa: E402
from portbench.reference import curve  # noqa: E402
from portbench.reference.spartan import Reference, eq_table, evaluate, fields_differing, suffix_tables  # noqa: E402

GOLDEN = ROOT / "tests" / "fixtures" / "proof_2e5_seed3.bin"


def _golden_reference():
    shape = generator.Shape(5, 4, 1)
    a, b, c = generator.matrices(shape, 3)
    v, w = generator.instance(shape, 3, generator.offsets_of(shape, 3))
    return Reference(a, b, c, 7), v, w


def test_golden_proof_2e5():
    """The proof the JAX package made for circuit seed 3 (density 1) under
    key seed 7, byte for byte."""
    ref, v, w = _golden_reference()
    fields = ref.prove(v, w)
    want = GOLDEN.read_bytes()
    assert fields_differing(fields, want) == []
    assert b"".join(b for _n, b in fields) == want


def test_control_differs_from_golden():
    """The control (v left out of the transcript) keeps the commitment and
    changes every field after the first challenge."""
    ref, v, w = _golden_reference()
    got = b"".join(b for _n, b in ref.prove(v, w, absorb_public_input=False))
    names = fields_differing(ref.prove(v, w), got)
    assert names and not any(n.startswith("pm1.") for n in names)
    assert "pm2.eval" in names and "pm6.level4" in names


def test_one_changed_byte_is_one_field():
    ref, v, w = _golden_reference()
    want = ref.prove(v, w)
    data = bytearray(GOLDEN.read_bytes())
    data[200] ^= 1
    assert len(fields_differing(want, bytes(data))) == 1
    assert fields_differing(want, GOLDEN.read_bytes()[:-1]) == [want[-1][0]]


def test_trapdoor_keys():
    """A level's combined G2 key is the sum of its entries 2j and 2j + 1,
    and the last level's key is g (or h) itself."""
    keys = Reference(*generator.matrices(generator.Shape(5, 4, 1), 3), 7).keys
    for level, j in ((0, 3), (2, 1), (4, 0)):
        pair = curve.G2.add(keys.g2_key(level, 2 * j), keys.g2_key(level, 2 * j + 1))
        assert pair == keys.g2_comb_key(level, j)
    assert keys.g1_key(5, 0) == keys.g and keys.g2_key(5, 0) == keys.h
    assert curve.G1.on_curve(keys.g1_key(1, 5)) and curve.G2.on_curve(keys.g2_key(3, 2))


def test_group_order_and_encoding():
    assert curve.G1.mul(curve.G1_GEN, curve.R - 1) == (curve.G1_GEN[0], curve.P - curve.G1_GEN[1])
    two = curve.G2.mul(curve.G2_GEN, 2)
    assert curve.G2.add(curve.G2_GEN, curve.G2_GEN) == two and curve.G2.on_curve(two)
    # the G1 generator's y is the smaller root: no flag on x's top byte
    assert curve.ser_g1(curve.G1_GEN)[::-1].hex().startswith("17f1d3a73197d794")
    assert curve.ser_g1(curve.G1.mul(curve.G1_GEN, curve.R - 1))[::-1].hex().startswith("97f1d3a73197d794")
    assert curve.ser_g1(None) == bytes(47) + b"\x40"


def test_eq_tables_agree():
    rng = np.random.default_rng(5)
    pt = [int(x) for x in rng.integers(1, 1 << 62, size=4)]
    tab = eq_table(pt)
    assert suffix_tables(pt)[0].tolist() == tab.tolist()
    f = np.empty(16, dtype=object)
    f[:] = [int(x) for x in rng.integers(0, 1 << 62, size=16)]
    assert evaluate(f, pt) == int(np.sum(f * tab) % curve.R)


@pytest.mark.parametrize("log_n", [10, 11, 12])
def test_reference_time(log_n, capsys):
    """The reference's time a proof at density 0; 2^16 is 16 times 2^12's
    in the limit of its O(n) work (PERF.md, section 2)."""
    shape = generator.Shape(log_n, 4, 0)
    mats = generator.matrices(shape, 1)
    v, w = generator.instance(shape, 1, generator.offsets_of(shape, 1))
    t = time.perf_counter()
    ref = Reference(*mats, 5)
    t_setup = time.perf_counter() - t
    t = time.perf_counter()
    fields = ref.prove(v, w)
    t_prove = time.perf_counter() - t
    # pm1 2, each opening 3 + log_n, pm3 2, sc1 1 + log_n (1 + log_n + 3), pm4 3, pm5 2, sc2 1 + 4 log_n
    assert len(fields) == 2 + 2 * (3 + log_n) + 2 + 1 + log_n * (log_n + 4) + 3 + 2 + 1 + 4 * log_n
    with capsys.disabled():
        print(f"\nreference at 2^{log_n}: set-up {t_setup:.3f} s, a proof {t_prove:.3f} s; "
              f"x{2 ** (16 - log_n)} for 2^16: {t_prove * 2 ** (16 - log_n):.1f} s at most")
    assert math.isfinite(t_prove)
