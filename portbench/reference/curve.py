"""BLS12-381 in Python integers: Fr and Fp constants, Fp2, the groups G1
and G2 in Jacobian coordinates, scalar multiplication and the compressed
wire encoding of affine points.

Written from the curve's public definition (the IETF pairing-friendly
curves draft, section 4.2.1) and arkworks' compressed serialization; it
shares no code with the program it judges. Affine points are tuples
``(x, y)``, with ``None`` for the point at infinity; an Fp2 element is a
pair ``(c0, c1) = c0 + c1 u`` with ``u^2 = -1``.
"""

from __future__ import annotations

P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001

G1_GEN = (
    0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB,
    0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1,
)
G2_GEN = (
    (0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8,
     0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E),
    (0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801,
     0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE),
)

FP_BYTES = 48


class _Fp:
    """Fp operations on ints."""

    zero, one = 0, 1

    @staticmethod
    def add(a, b):
        return (a + b) % P

    @staticmethod
    def sub(a, b):
        return (a - b) % P

    @staticmethod
    def mul(a, b):
        return a * b % P

    @staticmethod
    def inv(a):
        return pow(a, -1, P)


class _Fp2:
    """Fp2 = Fp[u] / (u^2 + 1) operations on pairs."""

    zero, one = (0, 0), (1, 0)

    @staticmethod
    def add(a, b):
        return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)

    @staticmethod
    def sub(a, b):
        return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)

    @staticmethod
    def mul(a, b):
        t0, t1 = a[0] * b[0], a[1] * b[1]
        return ((t0 - t1) % P, ((a[0] + a[1]) * (b[0] + b[1]) - t0 - t1) % P)

    @staticmethod
    def inv(a):
        n = pow((a[0] * a[0] + a[1] * a[1]) % P, -1, P)
        return (a[0] * n % P, -a[1] * n % P)


class Group:
    """y^2 = x^3 + b over the field ``f`` (a = 0), Jacobian inside."""

    def __init__(self, f, b, gen):
        self.f, self.b, self.gen = f, b, gen

    def on_curve(self, pt) -> bool:
        if pt is None:
            return True
        f = self.f
        x, y = pt
        return f.mul(y, y) == f.add(f.mul(f.mul(x, x), x), self.b)

    def _double(self, X, Y, Z):
        f = self.f
        if Z == f.zero:
            return X, Y, Z
        a = f.mul(X, X)
        b = f.mul(Y, Y)
        c = f.mul(b, b)
        xb = f.add(X, b)
        d = f.sub(f.sub(f.mul(xb, xb), a), c)
        d = f.add(d, d)
        e = f.add(f.add(a, a), a)
        x3 = f.sub(f.mul(e, e), f.add(d, d))
        c8 = f.add(c, c)
        c8 = f.add(c8, c8)
        c8 = f.add(c8, c8)
        y3 = f.sub(f.mul(e, f.sub(d, x3)), c8)
        yz = f.mul(Y, Z)
        return x3, y3, f.add(yz, yz)

    def _add_affine(self, X, Y, Z, pt):
        """Jacobian (X, Y, Z) plus the affine point pt."""
        f = self.f
        if pt is None:
            return X, Y, Z
        x2, y2 = pt
        if Z == f.zero:
            return x2, y2, f.one
        zz = f.mul(Z, Z)
        u2 = f.mul(x2, zz)
        s2 = f.mul(f.mul(y2, Z), zz)
        h = f.sub(u2, X)
        r = f.sub(s2, Y)
        if h == f.zero:
            if r == f.zero:
                return self._double(X, Y, Z)
            return f.one, f.one, f.zero
        hh = f.mul(h, h)
        hhh = f.mul(h, hh)
        v = f.mul(X, hh)
        x3 = f.sub(f.sub(f.mul(r, r), hhh), f.add(v, v))
        y3 = f.sub(f.mul(r, f.sub(v, x3)), f.mul(Y, hhh))
        return x3, y3, f.mul(Z, h)

    def _affine(self, X, Y, Z):
        f = self.f
        if Z == f.zero:
            return None
        zi = f.inv(Z)
        zi2 = f.mul(zi, zi)
        return f.mul(X, zi2), f.mul(Y, f.mul(zi2, zi))

    def mul(self, pt, k: int):
        """k * pt, by double-and-add from the top bit."""
        k %= R
        if pt is None or k == 0:
            return None
        f = self.f
        X, Y, Z = f.one, f.one, f.zero
        for bit in bin(k)[2:]:
            X, Y, Z = self._double(X, Y, Z)
            if bit == "1":
                X, Y, Z = self._add_affine(X, Y, Z, pt)
        return self._affine(X, Y, Z)

    def add(self, p1, p2):
        if p1 is None:
            return p2
        X, Y, Z = self._add_affine(p1[0], p1[1], self.f.one, p2)
        return self._affine(X, Y, Z)


G1 = Group(_Fp, 4, G1_GEN)
G2 = Group(_Fp2, (4, 4), G2_GEN)


def ser_g1(pt) -> bytes:
    """arkworks' compressed G1: x little-endian in 48 bytes; bit 7 of the
    last byte set when y is the larger of y and -y, bit 6 for infinity."""
    if pt is None:
        return bytes(FP_BYTES - 1) + b"\x40"
    x, y = pt
    b = bytearray(x.to_bytes(FP_BYTES, "little"))
    if y > P - y:
        b[-1] |= 0x80
    return bytes(b)


def ser_g2(pt) -> bytes:
    """arkworks' compressed G2: x.c0 || x.c1, each 48 bytes little-endian;
    y is the larger when (y.c1, y.c0) > (-y.c1, -y.c0) lexicographically."""
    if pt is None:
        return bytes(2 * FP_BYTES - 1) + b"\x40"
    (x0, x1), (y0, y1) = pt
    b = bytearray(x0.to_bytes(FP_BYTES, "little") + x1.to_bytes(FP_BYTES, "little"))
    if (y1, y0) > ((-y1) % P, (-y0) % P):
        b[-1] |= 0x80
    return bytes(b)
