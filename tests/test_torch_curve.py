"""Port point kernels' plain versions vs spartan_tpu.ops.curve and the host
oracle, on the edge lanes P + Q, P + P, P + (-P), inf + P, P + inf.

The port evaluates the same formulas as the JAX jnp path, so Jacobian limbs
agree exactly after repacking; affine results agree with host/curve.py.
"""

import random

import numpy as np
import pytest
import torch

from spartan_tpu.host import curve as hc
from spartan_tpu.host import field as hf
from spartan_tpu.ops import curve as jcv
from spartan_tpu_torch.ops import curve as tcv

torch.set_num_threads(1)  # small int64 tensors: one intra-op thread is fastest

GROUPS = {
    "g1": (hc.G1, hf.G1_GEN, jcv.G1_FIELD, jcv.g1_encode, tcv.g1_encode, tcv.g1_decode),
    "g2": (hc.G2, hf.G2_GEN, jcv.G2_FIELD, jcv.g2_encode, tcv.g2_encode, tcv.g2_decode),
}


def _lanes(group):
    ops, gen = GROUPS[group][:2]
    rng = random.Random(11)
    pts = [ops.mul(gen, rng.randrange(1, hf.R)) for _ in range(4)]
    #      P + Q     P + P    P + (-P)          inf + P  P + inf
    ps = [pts[0], pts[1], pts[2], None, pts[3]]
    qs = [pts[3], pts[1], ops.neg(pts[2]), pts[0], None]
    return ops, ps, qs


def _jax_to_port(jp, group):
    return tcv.from_jax(jax_tree_numpy(jp), group)


def jax_tree_numpy(jp):
    if isinstance(jp.x, tuple):
        return tuple(tuple(np.asarray(c) for c in coord) for coord in jp)
    return tuple(np.asarray(c) for c in jp)


@pytest.mark.parametrize("group", ["g1", "g2"])
@pytest.mark.parametrize("op", ["add_mixed", "add", "double"])
def test_point_ops_match_jax_and_host(group, op):
    ops, _gen, jfield, jenc, tenc, tdec = GROUPS[group]
    _ops, ps, qs = _lanes(group)
    # P as a Jacobian point with Z != 1: double the affine encodings first
    jp = jcv.double(jfield, jenc(ps))
    tp = tcv.double(tenc(ps))
    assert torch.equal(_jax_to_port(jp, group).data, tp.data)
    base = [ops.double(p) for p in ps]
    if op == "double":
        jr, tr = jcv.double(jfield, jp), tcv.double(tp)
        want = [ops.double(p) for p in base]
    elif op == "add_mixed":
        # Q affine; add 2P + Q, and on the P + P lane use Q = 2P so the
        # doubling rule is hit
        qs2 = list(qs)
        qs2[1] = base[1]
        qs2[2] = ops.neg(base[2])
        jr = jcv.add_mixed(jfield, jp, jenc(qs2))
        tr = tcv.add_mixed(tp, tenc(qs2))
        want = [ops.add(p, q) for p, q in zip(base, qs2)]
    else:
        # Q Jacobian too: 2Q; lanes 1, 2 give 2P + 2P and 2P - 2P
        qs2 = list(qs)
        qs2[1] = ps[1]
        qs2[2] = ops.neg(ps[2])
        jq = jcv.double(jfield, jenc(qs2))
        jr = jcv.add(jfield, jp, jq)
        tr = tcv.add(tp, tcv.double(tenc(qs2)))
        want = [ops.add(p, ops.double(q)) for p, q in zip(base, qs2)]
    assert torch.equal(_jax_to_port(jr, group).data, tr.data)
    assert tdec(tr) == want
    if op != "double":  # the P + (-P) lane is the point at infinity
        assert want[2] is None


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_encode_decode_and_affine(group):
    ops, gen, _jf, _je, tenc, tdec = GROUPS[group]
    pts = [ops.mul(gen, k) for k in (1, 2, 3)] + [None]
    b = tenc(pts)
    assert tdec(b) == pts
    aff = tcv.normalize(tcv.double(b))
    assert tdec(aff) == [ops.double(p) for p in pts]
    assert torch.equal(aff.data[..., 3], torch.zeros_like(aff.data[..., 3]))
    assert tcv.is_infinity(aff).tolist() == [False, False, False, True]


def test_wrapper_never_falls_back_off_cpu():
    """A tensor that is not on the CPU goes to the kernel path, which only
    takes CUDA tensors: it raises instead of running the plain version."""
    p = tcv.infinity("g1", 4, device="meta")
    with pytest.raises(ValueError, match="kernel needs CUDA"):
        tcv.double(p)


def test_host_field_constants_match_jax_package():
    from spartan_tpu_torch.host import field as thf

    for name in ("P", "R", "B_G1", "B_G2", "G1_GEN", "G2_GEN", "FP2_ZERO", "FP2_ONE"):
        assert getattr(thf, name) == getattr(hf, name), name
    rng = random.Random(2)
    a = (rng.randrange(hf.P), rng.randrange(hf.P))
    b = (rng.randrange(hf.P), rng.randrange(hf.P))
    for fn in ("fp2_add", "fp2_sub", "fp2_mul"):
        assert getattr(thf, fn)(a, b) == getattr(hf, fn)(a, b), fn
    for fn in ("fp2_neg", "fp2_sq", "fp2_inv"):
        assert getattr(thf, fn)(a) == getattr(hf, fn)(a), fn
    assert thf.fr_inv(a[0] % hf.R) == hf.fr_inv(a[0] % hf.R)
    assert thf.fp_inv(a[0]) == hf.fp_inv(a[0])


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_host_curve_ops_match_jax_package(group):
    from spartan_tpu_torch.host import curve as thc

    ops, gen = GROUPS[group][:2]
    mine = thc.G1 if group == "g1" else thc.G2
    rng = random.Random(5)
    k1, k2 = rng.randrange(hf.R), rng.randrange(1 << 64)
    p, q = mine.mul(gen, k1), mine.mul(gen, k2)
    assert p == ops.mul(gen, k1) and q == ops.mul(gen, k2)
    assert mine.add(p, q) == ops.add(p, q)
    assert mine.double(p) == ops.double(p)
    assert mine.add(p, mine.neg(p)) is None
    assert mine.add(None, q) == q and mine.double(None) is None
    assert mine.is_on_curve(mine.add(p, q))
    if group == "g1":
        assert thc.g1_lincomb([p, q], [3, 5]) == hc.g1_lincomb([p, q], [3, 5])


_JAX_DOUBLINGS = {}


def _jax_doublings(group: str, upto: int):
    """2^j P for j = 0..upto by the JAX package's jnp double over the
    group's field, on the test lanes (infinity among them), computed once."""
    if group not in _JAX_DOUBLINGS:
        jfield, jenc = GROUPS[group][2:4]
        _ops, ps, _qs = _lanes(group)
        jp = jcv.double(jfield, jenc(ps))  # Jacobian, Z != 1
        out = [jp]
        for _ in range(upto):
            jp = jcv.double(jfield, jp)
            out.append(jp)
        _JAX_DOUBLINGS[group] = out
    return _JAX_DOUBLINGS[group]


@pytest.mark.parametrize("group", ["g1", "g2"])
@pytest.mark.parametrize("k", [1, 4, 8])
def test_g2_k_fold_double_matches_k_jax_doubles(k, group):
    """One k-fold double (one kernel launch on the card) against k doublings
    of the JAX package, for both groups."""
    jd = _jax_doublings(group, 8)
    start = _jax_to_port(jd[0], group)
    got = tcv.double(start, k)
    assert torch.equal(got.data, tcv.double_plain(start, k).data)
    assert torch.equal(got.data, _jax_to_port(jd[k], group).data)
    ops, ps, _qs = _lanes(group)
    want = [ops.double(p) for p in ps]
    for _ in range(k):
        want = [ops.double(p) for p in want]
    assert GROUPS[group][5](got) == want
    assert want[3] is None  # the infinity lane stays infinity


def test_g2_team_header_is_generated_from_the_programs():
    from spartan_tpu_torch.ops import team

    text = team.HEADER.read_text()
    assert text == team.emit_header()
    for g in team.GROUPS.values():  # every program of both groups has its tables
        for name in g.programs:
            for table in ("END", "OPS"):
                assert f"{g.prefix}_{name}_{table}[" in text
    assert "G1T_ADD_CHECK[2]" in text and "G2T_ADD_CHECK[4]" in text


def _coords(batch, lane):
    from spartan_tpu_torch.ops import field as fo
    from spartan_tpu_torch.ops.field import FP

    return fo.decode_mont(FP, batch.data[:, :, lane].T.contiguous())


@pytest.mark.parametrize("op", ["add", "double"])
def test_g2_team_programs_match_plain_formulas(op):
    """The stage programs the team kernels run, with the kernel's edge rules,
    on every test lane (P + Q, P + P, P + (-P), inf + P, P + inf)."""
    from spartan_tpu_torch.ops import team

    ops, ps, qs = _lanes("g2")
    qs2 = list(qs)
    qs2[1] = ps[1]
    tp = tcv.double(tcv.g2_encode(ps))
    tq = tcv.double(tcv.g2_encode(qs2))
    want = tcv.add_plain(tp, tq) if op == "add" else tcv.double_plain(tp, 3)
    for lane in range(tp.n):
        pc = _coords(tp, lane)
        got = team.team_add(pc, _coords(tq, lane), hf.P) if op == "add" else \
            team.team_double(pc, 3, hf.P)
        assert got == _coords(want, lane), lane


def test_g2_team_madd_program_matches_plain_and_jax():
    """The mixed add's stage program, with the kernel's edge rules, against
    curve.add_mixed_plain and the JAX package's add_mixed over G2_FIELD:
    P + Q, P + P, P + (-P), inf + Q, P + inf, with P Jacobian (Z != 1) and
    Q affine."""
    from spartan_tpu_torch.ops import team

    ops, ps, qs = _lanes("g2")
    base = [ops.double(p) for p in ps]
    qs2 = list(qs)
    qs2[1] = base[1]  # P == Q: the doubling rule
    qs2[2] = ops.neg(base[2])  # P == -Q: infinity
    jp = jcv.double(jcv.G2_FIELD, jcv.g2_encode(ps))
    tp, tq = tcv.double(tcv.g2_encode(ps)), tcv.g2_encode(qs2)
    want = tcv.add_mixed_plain(tp, tq)
    assert torch.equal(_jax_to_port(jcv.add_mixed(jcv.G2_FIELD, jp, jcv.g2_encode(qs2)), "g2").data,
                       want.data)
    for lane in range(tp.n):
        got = team.team_add(_coords(tp, lane), _coords(tq, lane), hf.P, "MADD")
        assert got == _coords(want, lane), lane
    assert tcv.g2_decode(want) == [ops.add(p, q) for p, q in zip(base, qs2)]
    assert tcv.g2_decode(want)[2] is None


@pytest.mark.parametrize("op", ["add", "double"])
def test_g1_team_programs_match_plain_and_jax(op):
    """The G1 stage programs (run by team_add / team_double over p = the Fp
    modulus), with the kernel's edge rules, against curve.add_plain /
    double_plain and the JAX package's add / double over G1_FIELD, on
    P + Q, P + P, P + (-P), inf + Q and P + inf with P and Q Jacobian
    (Z != 1)."""
    from spartan_tpu_torch.ops import team

    ops, ps, qs = _lanes("g1")
    qs2 = list(qs)
    qs2[1] = ps[1]  # 2P + 2P: the doubling rule
    jp, jq = (jcv.double(jcv.G1_FIELD, jcv.g1_encode(x)) for x in (ps, qs2))
    tp, tq = tcv.double(tcv.g1_encode(ps)), tcv.double(tcv.g1_encode(qs2))
    if op == "add":
        want = tcv.add_plain(tp, tq)
        jr = jcv.add(jcv.G1_FIELD, jp, jq)
        host = [ops.add(ops.double(p), ops.double(q)) for p, q in zip(ps, qs2)]
    else:
        want = tcv.double_plain(tp, 2)
        jr = jcv.double(jcv.G1_FIELD, jcv.double(jcv.G1_FIELD, jp))
        host = [ops.double(ops.double(ops.double(p))) for p in ps]
    assert torch.equal(_jax_to_port(jr, "g1").data, want.data)
    assert tcv.g1_decode(want) == host
    for lane in range(tp.n):
        pc = _coords(tp, lane)
        got = team.team_add(pc, _coords(tq, lane), hf.P) if op == "add" else \
            team.team_double(pc, 2, hf.P)
        assert got == _coords(want, lane), lane
    if op == "add":
        assert host[2] is None and host[3] == ops.double(qs2[3]) and host[4] == ops.double(ps[4])
