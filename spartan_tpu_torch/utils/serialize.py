"""Canonical serialization in the arkworks layout, the port's copy of
``spartan_tpu/utils/serialize.py``. The transcript absorbs these bytes and
proofs are written in them, so they must equal the JAX package's byte for
byte.

- Fr, Fp: little-endian bytes of the canonical integer, 32 bytes for Fr and
  48 for Fp.
- usize: u64 little-endian. Vec<T>: u64 LE length, then the elements.
- G1/G2 affine compressed: the x-coordinate bytes (Fp2 as c0 || c1) with
  flags in the top bits of the last byte: bit 7 = y is the larger root,
  bit 6 = point at infinity.
"""

from __future__ import annotations

import struct

from spartan_tpu_torch.host import field as hf

FR_BYTES = 32
FP_BYTES = 48


def ser_u64(x: int) -> bytes:
    return struct.pack("<Q", x)


def ser_fr(x: int) -> bytes:
    return int(x % hf.R).to_bytes(FR_BYTES, "little")


def deser_fr(b: bytes, off: int = 0):
    return int.from_bytes(b[off : off + FR_BYTES], "little"), off + FR_BYTES


def ser_fr_vec(xs) -> bytes:
    return ser_u64(len(xs)) + b"".join(ser_fr(x) for x in xs)


def ser_matrix(rows) -> bytes:
    """Matrix<Fr> = Vec<Vec<(Fr, usize)>>: the native serializer where the
    host library is built, else ``ser_matrix_py`` (the same bytes)."""
    from spartan_tpu_torch.host.native import ser_matrix_native

    fast = ser_matrix_native(rows)
    return ser_matrix_py(rows) if fast is None else fast


def ser_matrix_py(rows) -> bytes:
    out = [ser_u64(len(rows))]
    for row in rows:
        out.append(ser_u64(len(row)))
        for coeff, idx in row:
            out.append(ser_fr(coeff))
            out.append(ser_u64(idx))
    return b"".join(out)


def _y_is_largest_fp(y: int) -> bool:
    return y > hf.P - y


def ser_g1(pt) -> bytes:
    """G1 affine compressed: 48 bytes."""
    if pt is None:
        b = bytearray(FP_BYTES)
        b[-1] |= 0x40
        return bytes(b)
    x, y = pt
    b = bytearray(int(x).to_bytes(FP_BYTES, "little"))
    if _y_is_largest_fp(y):
        b[-1] |= 0x80
    return bytes(b)


def deser_g1(data: bytes, off: int = 0):
    """Inverse of ser_g1: y from the curve equation."""
    raw = bytearray(data[off : off + FP_BYTES])
    flags = raw[-1] & 0xC0
    raw[-1] &= 0x3F
    off += FP_BYTES
    if flags & 0x40:
        return None, off
    x = int.from_bytes(bytes(raw), "little")
    y = _sqrt_fp((x * x % hf.P * x + hf.B_G1) % hf.P)
    if y is None:
        raise ValueError("invalid G1 x-coordinate")
    if _y_is_largest_fp(y) != bool(flags & 0x80):
        y = hf.P - y
    return (x, y), off


def ser_g2(pt) -> bytes:
    """G2 affine compressed: 96 bytes (x.c0 LE || x.c1 LE, flags on the last byte)."""
    if pt is None:
        b = bytearray(2 * FP_BYTES)
        b[-1] |= 0x40
        return bytes(b)
    (x0, x1), y = pt
    b = bytearray(int(x0).to_bytes(FP_BYTES, "little") + int(x1).to_bytes(FP_BYTES, "little"))
    if _y2_is_largest(y):
        b[-1] |= 0x80
    return bytes(b)


def deser_g2(data: bytes, off: int = 0):
    raw = bytearray(data[off : off + 2 * FP_BYTES])
    flags = raw[-1] & 0xC0
    raw[-1] &= 0x3F
    off += 2 * FP_BYTES
    if flags & 0x40:
        return None, off
    x = (int.from_bytes(bytes(raw[:FP_BYTES]), "little"),
         int.from_bytes(bytes(raw[FP_BYTES:]), "little"))
    y = _sqrt_fp2(hf.fp2_add(hf.fp2_mul(hf.fp2_sq(x), x), hf.B_G2))
    if y is None:
        raise ValueError("invalid G2 x-coordinate")
    if _y2_is_largest(y) != bool(flags & 0x80):
        y = hf.fp2_neg(y)
    return (x, y), off


def _y2_is_largest(y) -> bool:
    """Lexicographic order on (c1, c0)."""
    ny = hf.fp2_neg(y)
    return (y[1], y[0]) > (ny[1], ny[0])


def _sqrt_fp(a: int):
    """Square root in Fp (p = 3 mod 4): a^((p+1)/4)."""
    r = pow(a, (hf.P + 1) // 4, hf.P)
    return r if r * r % hf.P == a % hf.P else None


def _sqrt_fp2(a):
    """Square root in Fp2 through the norm (p = 3 mod 4)."""
    if a == hf.FP2_ZERO:
        return hf.FP2_ZERO
    a0, a1 = a
    if a1 == 0:
        s = _sqrt_fp(a0)
        if s is not None:
            return (s, 0)
        # a0 = -(t^2): the root is t u
        s = _sqrt_fp((-a0) % hf.P)
        return None if s is None else (0, s)
    n = _sqrt_fp((a0 * a0 + a1 * a1) % hf.P)
    if n is None:
        return None
    for sign in (1, -1):
        alpha = (a0 + sign * n) % hf.P * pow(2, hf.P - 2, hf.P) % hf.P
        x0 = _sqrt_fp(alpha)
        if x0 is None:
            continue
        x1 = a1 * pow(2 * x0 % hf.P, hf.P - 2, hf.P) % hf.P
        if hf.fp2_sq((x0, x1)) == (a0 % hf.P, a1 % hf.P):
            return (x0, x1)
    return None
