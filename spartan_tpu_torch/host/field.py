"""Host-side (Python-int) BLS12-381 field arithmetic: Fr and Fp constants,
Fp inversion and Fp2 = Fp[u]/(u^2 + 1).

The port's copy of the part of ``spartan_tpu/host/field.py`` it uses: the
curve oracle (``host/curve.py``), compressed point serialization and the
protocol's Fr arithmetic. The Fp6/Fp12 tower stays behind: the port's
pairings run in the native library (``host/pairing.py``).

Fp elements are Python ints; Fp2 elements are 2-tuples (c0, c1) = c0 + c1 u.
"""

from __future__ import annotations

# BLS12-381 base field modulus (381 bits)
P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
# BLS12-381 scalar field modulus (255 bits), "Fr"
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001

# Curve equation constants: G1: y^2 = x^3 + 4; G2 (twist): y^2 = x^3 + 4(u+1)
B_G1 = 4
B_G2 = (4, 4)

# Generators (standard, from the BLS12-381 spec)
G1_GEN = (
    0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB,
    0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1,
)
G2_GEN = (
    (
        0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8,
        0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E,
    ),
    (
        0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801,
        0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE,
    ),
)


def fr_inv(a: int) -> int:
    if a % R == 0:
        raise ZeroDivisionError("inverse of zero in Fr")
    return pow(a, -1, R)


def fp_inv(a: int) -> int:
    if a % P == 0:
        raise ZeroDivisionError("inverse of zero in Fp")
    return pow(a, -1, P)


FP2_ZERO = (0, 0)
FP2_ONE = (1, 0)


def fp2_add(a, b):
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def fp2_sub(a, b):
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def fp2_neg(a):
    return ((-a[0]) % P, (-a[1]) % P)


def fp2_mul(a, b):
    # Karatsuba: (a0 + a1 u)(b0 + b1 u) = (a0b0 - a1b1) + ((a0+a1)(b0+b1) - a0b0 - a1b1) u
    t0 = a[0] * b[0]
    t1 = a[1] * b[1]
    t2 = (a[0] + a[1]) * (b[0] + b[1])
    return ((t0 - t1) % P, (t2 - t0 - t1) % P)


def fp2_sq(a):
    # (a0 + a1 u)^2 = (a0+a1)(a0-a1) + 2 a0 a1 u
    t0 = (a[0] + a[1]) * (a[0] - a[1])
    t1 = 2 * a[0] * a[1]
    return (t0 % P, t1 % P)


def fp2_inv(a):
    # 1 / (a0 + a1 u) = (a0 - a1 u) / (a0^2 + a1^2)
    norm = (a[0] * a[0] + a[1] * a[1]) % P
    n_inv = fp_inv(norm)
    return (a[0] * n_inv % P, (-a[1]) * n_inv % P)
