"""Host-side (Python-int) BLS12-381 G1/G2 group arithmetic, the port's copy
of ``spartan_tpu/host/curve.py``.

The scalar oracle that the point kernels are held against, and the host
jobs of keygen and verify (generator scaling, the fixed-base tables'
doublings, the verifier's G1 linear combinations).

Points are affine tuples ``(x, y)`` with ``None`` as the point at infinity.
One ``CurveOps`` class serves G1 (Fp) and G2 (Fp2) through small op tables.
"""

from __future__ import annotations

from spartan_tpu_torch.host import field as hf


class CurveOps:
    """Affine short-Weierstrass arithmetic y^2 = x^3 + b over a field."""

    def __init__(self, add, sub, mul, sq, neg, inv, zero, one, b):
        self.fadd, self.fsub, self.fmul, self.fsq = add, sub, mul, sq
        self.fneg, self.finv, self.zero, self.one, self.b = neg, inv, zero, one, b
        self._three = 3 if one == 1 else add(add(one, one), one)

    def is_on_curve(self, pt) -> bool:
        if pt is None:
            return True
        x, y = pt
        return self.fsq(y) == self.fadd(self.fmul(self.fsq(x), x), self.b)

    def neg(self, pt):
        if pt is None:
            return None
        return (pt[0], self.fneg(pt[1]))

    def double(self, pt):
        if pt is None:
            return None
        x, y = pt
        if y == self.zero:
            return None
        # lambda = 3x^2 / 2y
        lam = self.fmul(self.fmul(self.fsq(x), self._three), self.finv(self.fadd(y, y)))
        x3 = self.fsub(self.fsq(lam), self.fadd(x, x))
        y3 = self.fsub(self.fmul(lam, self.fsub(x, x3)), y)
        return (x3, y3)

    def add(self, p1, p2):
        if p1 is None:
            return p2
        if p2 is None:
            return p1
        x1, y1 = p1
        x2, y2 = p2
        if x1 == x2:
            if y1 == y2:
                return self.double(p1)
            return None
        lam = self.fmul(self.fsub(y2, y1), self.finv(self.fsub(x2, x1)))
        x3 = self.fsub(self.fsq(lam), self.fadd(x1, x2))
        y3 = self.fsub(self.fmul(lam, self.fsub(x1, x3)), y1)
        return (x3, y3)

    def mul(self, pt, k: int):
        k = k % hf.R
        result = None
        addend = pt
        while k:
            if k & 1:
                result = self.add(result, addend)
            addend = self.double(addend)
            k >>= 1
        return result


G1 = CurveOps(
    add=lambda a, b: (a + b) % hf.P,
    sub=lambda a, b: (a - b) % hf.P,
    mul=lambda a, b: (a * b) % hf.P,
    sq=lambda a: (a * a) % hf.P,
    neg=lambda a: (-a) % hf.P,
    inv=hf.fp_inv,
    zero=0,
    one=1,
    b=hf.B_G1,
)
G2 = CurveOps(
    add=hf.fp2_add,
    sub=hf.fp2_sub,
    mul=hf.fp2_mul,
    sq=hf.fp2_sq,
    neg=hf.fp2_neg,
    inv=hf.fp2_inv,
    zero=hf.FP2_ZERO,
    one=hf.FP2_ONE,
    b=hf.B_G2,
)


def g1_lincomb(points, scalars):
    """sum_i s_i * P_i over G1: the native Jacobian path, or the affine
    Python oracle (the same point) where the native library is missing."""
    from spartan_tpu_torch.host import native

    res = native.g1_lincomb_native(points, scalars)
    if res is native.INF_POINT:
        return None
    if res is not None:
        return res
    acc = None
    for pt, s in zip(points, scalars):
        acc = G1.add(acc, G1.mul(pt, s))
    return acc
