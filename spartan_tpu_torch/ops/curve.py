"""Batched short-Weierstrass Jacobian point arithmetic for G1 and G2.

Counterpart of ``spartan_tpu/ops/curve.py``. A ``PointBatch`` holds one
``(C, 12, N)`` int32 tensor of Montgomery Fp limbs: C = 3 for G1
(x, y, z) and C = 6 for G2 (x.c0, x.c1, y.c0, y.c1, z.c0, z.c1). Infinity
is Z = 0; after ``normalize`` it is x = y = z = 0, and a finite affine point
has z = 1 (Montgomery one).

``double``, ``add`` and ``add_mixed`` are the wrappers of the point kernels
K3 (G1, ``csrc/g1_team.cu``) and K4 (G2, ``csrc/g2_team.cu``); the double
takes a repeat count k and returns 2^k P in one launch. For CPU
tensors they run the plain PyTorch versions beside them (``*_plain``), which
evaluate the same formulas (dbl-2009-l, add-2007-bl, madd-2007-bl, a = 0)
with the same edge-lane rules, so kernel and plain version agree limb for
limb. The plain versions batch independent field products into one call.
"""

from __future__ import annotations

from typing import List

import torch

from spartan_tpu_torch import kernels
from spartan_tpu_torch.ops import field as fo
from spartan_tpu_torch.ops import fp2
from spartan_tpu_torch.ops.field import FP

NCOORD = {"g1": 3, "g2": 6}


class PointBatch:
    """N Jacobian points of one group, as a (C, 12, N) int32 tensor."""

    __slots__ = ("data", "group")

    def __init__(self, data: torch.Tensor, group: str):
        if group not in NCOORD:
            raise ValueError(f"unknown group {group!r}")
        if data.dim() != 3 or data.shape[0] != NCOORD[group] or data.shape[1] != FP.nlimb:
            raise ValueError(f"{group} points need shape ({NCOORD[group]}, 12, N), got {tuple(data.shape)}")
        self.data = data
        self.group = group

    @property
    def n(self) -> int:
        return self.data.shape[-1]

    @property
    def device(self):
        return self.data.device

    def take(self, idx) -> "PointBatch":
        """Lanes at ``idx`` (an index tensor or a slice)."""
        if isinstance(idx, slice):
            return PointBatch(self.data[..., idx], self.group)
        return PointBatch(self.data.index_select(2, idx), self.group)

    @staticmethod
    def cat(parts: List["PointBatch"]) -> "PointBatch":
        return PointBatch(torch.cat([p.data for p in parts], dim=2), parts[0].group)


def infinity(group: str, n: int, device="cpu") -> PointBatch:
    return PointBatch(torch.zeros((NCOORD[group], FP.nlimb, n), dtype=torch.int32, device=device), group)


def is_infinity(p: PointBatch) -> torch.Tensor:
    zc = p.data[2:] if p.group == "g1" else p.data[4:]
    return (zc == 0).reshape(-1, p.n).all(0)


def select_point(mask: torch.Tensor, p: PointBatch, q: PointBatch) -> PointBatch:
    return PointBatch(torch.where(mask, p.data, q.data), p.group)


# ---------------------------------------------------------------------------
# Coordinate-field adapters for the plain formulas
# ---------------------------------------------------------------------------


class _G1Field:
    """Fp elements as (12, ...) tensors."""

    def __init__(self, f: fp2.FpOps):
        self.f = f

    def add(self, a, b):
        return self.f.add(a, b)

    def sub(self, a, b):
        return self.f.sub(a, b)

    AXIS = 1  # where muls and adds stack independent operations

    def muls(self, *pairs):
        return self._batched(self.f.mul, pairs)

    def adds(self, *pairs):
        """Independent sums as one call (the plain versions' cost is per call)."""
        return self._batched(self.f.add, pairs)

    def _batched(self, op, pairs):
        lhs = torch.stack([a for a, _ in pairs], dim=self.AXIS)
        rhs = torch.stack([b for _, b in pairs], dim=self.AXIS)
        return op(lhs, rhs).unbind(self.AXIS)

    def is_zero(self, a):
        return (a == 0).reshape(-1, a.shape[-1]).all(0)

    def coords(self, data):
        return data[0], data[1], data[2]

    def pack(self, x, y, z):
        return torch.stack([x, y, z])


class _G2Field(_G1Field):
    """Fp2 elements as (12, 2, ...) tensors."""

    def add(self, a, b):
        return fp2.add2(a, b, self.f)

    def sub(self, a, b):
        return fp2.sub2(a, b, self.f)

    AXIS = 2

    def muls(self, *pairs):
        return self._batched(lambda a, b: fp2.mul2(a, b, self.f), pairs)

    def coords(self, data):
        v = data.permute(1, 0, 2)  # (12, 6, N)
        return v[:, 0:2], v[:, 2:4], v[:, 4:6]

    def pack(self, x, y, z):
        return torch.cat([x, y, z], dim=1).permute(1, 0, 2)


_PLAIN = {"g1": _G1Field(fp2.PLAIN), "g2": _G2Field(fp2.PLAIN)}


def _dbl(f, a):
    return f.add(a, a)


def _double_coords(f, x, y, z):
    a, b = f.muls((x, x), (y, y))
    xb, a2 = f.adds((x, b), (a, a))
    c, t = f.muls((b, b), (xb, xb))
    ac, e = f.adds((a, c), (a2, a))
    d = _dbl(f, f.sub(t, ac))
    g, yz = f.muls((e, e), (y, z))
    d2, c2 = f.adds((d, d), (c, c))
    x3 = f.sub(g, d2)
    c4, z3 = f.adds((c2, c2), (yz, yz))
    (ed,) = f.muls((e, f.sub(d, x3)))
    return x3, f.sub(ed, _dbl(f, c4)), z3


def _resolve(f, p, q, x3, y3, z3, h, r):
    """The edge rules: P = inf -> Q; Q = inf -> P; P == Q -> double(P).
    The doubling runs only on the lanes that need it."""
    _px, _py, pz = f.coords(p.data)
    out = f.pack(x3, y3, z3)
    p_inf = f.is_zero(pz)
    q_inf = f.is_zero(f.coords(q.data)[2])
    same = f.is_zero(h) & f.is_zero(r) & ~p_inf & ~q_inf
    if bool(same.any()):
        lanes = torch.nonzero(same).squeeze(1)
        sub = p.data.index_select(2, lanes)
        out = out.clone()
        out[..., lanes] = f.pack(*_double_coords(f, *f.coords(sub)))
    out = torch.where(p_inf, q.data, out)
    out = torch.where(q_inf & ~p_inf, p.data, out)
    return PointBatch(out, p.group)


def double_plain(p: PointBatch, k: int = 1) -> PointBatch:
    """2^k P by k doublings, dbl-2009-l (a = 0); infinity stays infinity
    (Z = 0)."""
    f = _PLAIN[p.group]
    data = p.data
    for _ in range(k):
        data = f.pack(*_double_coords(f, *f.coords(data)))
    return PointBatch(data, p.group)


def _finite_lanes(formula, p: PointBatch, q: PointBatch) -> PointBatch:
    """``formula`` on the lanes where neither point is infinity; P = inf
    gives Q and Q = inf gives P, as ``_resolve`` does, without evaluating
    the formula there (an MSM's buckets are mostly empty)."""
    p_inf, q_inf = is_infinity(p), is_infinity(q)
    finite = ~(p_inf | q_inf)
    if bool(finite.all()):
        return formula(p, q)
    out = torch.where(p_inf, q.data, p.data)
    lanes = torch.nonzero(finite).squeeze(1)
    if lanes.numel():
        out[..., lanes] = formula(p.take(lanes), q.take(lanes)).data
    return PointBatch(out, p.group)


def add_plain(p: PointBatch, q: PointBatch) -> PointBatch:
    """Full Jacobian add, complete by the edge rules."""
    return _finite_lanes(_add_formula, p, q)


def add_mixed_plain(p: PointBatch, q: PointBatch) -> PointBatch:
    """Jacobian P + affine-encoded Q (Z2 = 1, or 0 for infinity)."""
    return _finite_lanes(_add_mixed_formula, p, q)


def _add_formula(p: PointBatch, q: PointBatch) -> PointBatch:
    f = _PLAIN[p.group]
    x1, y1, z1 = f.coords(p.data)
    x2, y2, z2 = f.coords(q.data)
    z1z1, z2z2 = f.muls((z1, z1), (z2, z2))
    u1, u2, t1, t2 = f.muls((x1, z2z2), (x2, z1z1), (y1, z2), (y2, z1))
    s1, s2 = f.muls((t1, z2z2), (t2, z1z1))
    h = f.sub(u2, u1)
    r = f.sub(s2, s1)
    h2, r2, z1z2 = f.muls((h, h), (r, r), (z1, z2))
    h3, u1h2, z3 = f.muls((h, h2), (u1, h2), (z1z2, h))
    x3 = f.sub(f.sub(r2, h3), _dbl(f, u1h2))
    ya, yb = f.muls((r, f.sub(u1h2, x3)), (s1, h3))
    return _resolve(f, p, q, x3, f.sub(ya, yb), z3, h, r)


def _add_mixed_formula(p: PointBatch, q: PointBatch) -> PointBatch:
    f = _PLAIN[p.group]
    x1, y1, z1 = f.coords(p.data)
    x2, y2, _z2 = f.coords(q.data)
    (z1z1,) = f.muls((z1, z1))
    u2, t2 = f.muls((x2, z1z1), (y2, z1))
    (s2,) = f.muls((t2, z1z1))
    h = f.sub(u2, x1)
    r = f.sub(s2, y1)
    h2, r2 = f.muls((h, h), (r, r))
    h3, u1h2, z3 = f.muls((h, h2), (x1, h2), (z1, h))
    x3 = f.sub(f.sub(r2, h3), _dbl(f, u1h2))
    ya, yb = f.muls((r, f.sub(u1h2, x3)), (y1, h3))
    return _resolve(f, p, q, x3, f.sub(ya, yb), z3, h, r)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _launch(op: str, p: PointBatch, q: PointBatch = None, args=()) -> PointBatch:
    ins = [p.data.contiguous()]
    if q is not None:
        if q.group != p.group or q.n != p.n:
            raise ValueError("point batches differ in group or length")
        ins.append(q.data.contiguous())
    out = torch.empty_like(ins[0])
    kernels.launch(f"{p.group}_{op}", out, *ins, args=args)
    return PointBatch(out, p.group)


def double(p: PointBatch, k: int = 1) -> PointBatch:
    """2^k P in one launch of the group's double kernel."""
    if k < 1:
        raise ValueError(f"doubling count k = {k} must be positive")
    if p.device.type == "cpu":
        return double_plain(p, k)
    return _launch("double", p, args=(k,))


def add(p: PointBatch, q: PointBatch) -> PointBatch:
    if p.device.type == "cpu" and q.device.type == "cpu":
        return add_plain(p, q)
    return _launch("add", p, q)


def add_mixed(p: PointBatch, q: PointBatch) -> PointBatch:
    if p.device.type == "cpu" and q.device.type == "cpu":
        return add_mixed_plain(p, q)
    return _launch("madd", p, q)


# ---------------------------------------------------------------------------
# Normalization and host codecs
# ---------------------------------------------------------------------------


def normalize_plain(p: PointBatch, f: fp2.FpOps = fp2.PLAIN) -> PointBatch:
    """``normalize`` as a composition over the Fp operations ``f`` (the
    plain versions by default): one batched inversion (Montgomery's trick,
    ``fo.batch_inv``, its root by Fermat), then z^-2, z^-3 and the affine
    coordinates (``spartan_tpu/ops/curve.py:270`` and the affine encoding
    of ``spartan_tpu/commitment/scheme.py:48``, ``:59``)."""
    inf = is_infinity(p)
    dev = p.device
    if p.group == "g1":
        x, y, z = p.data[0], p.data[1], p.data[2]
        zinv = fo.batch_inv(FP, z, f.mul, f.inv)
        zinv2 = f.mul(zinv, zinv)
        zinv3 = f.mul(zinv2, zinv)
        out = torch.stack([f.mul(x, zinv2), f.mul(y, zinv3), fo.ones_mont(FP, (p.n,), dev)])
    else:
        v = p.data.permute(1, 0, 2)
        x, y, z = v[:, 0:2], v[:, 2:4], v[:, 4:6]
        zinv = fp2.inv2(z, f)
        zinv2 = fp2.sq2(zinv, f)
        zinv3 = fp2.mul2(zinv2, zinv, f)
        ax = fp2.mul2(x, zinv2, f)
        ay = fp2.mul2(y, zinv3, f)
        one = fp2.make(fo.ones_mont(FP, (p.n,), dev), fo.zeros(FP, (p.n,), dev))
        out = torch.cat([ax, ay, one], dim=1).permute(1, 0, 2)
    out = torch.where(inf, torch.zeros_like(out), out)
    return PointBatch(out.contiguous(), p.group)


def normalize(p: PointBatch) -> PointBatch:
    """Jacobian -> affine-encoded batch (z = 1, or x = y = z = 0 for
    infinity): one launch of K2's ``g1_normalize`` or ``g2_normalize``
    (``csrc/normalize.cuh``), each lane inverting its own z. A CPU batch
    takes ``normalize_plain``."""
    if p.device.type == "cpu":
        return normalize_plain(p)
    src = p.data.contiguous()
    out = torch.empty_like(src)
    if p.n:
        kernels.call(f"{p.group}_normalize", [src, out], [p.n, 0], (p.n,))
    return PointBatch(out, p.group)


def _coords_host(p: PointBatch):
    """(C, 12, N) Montgomery limbs -> C lists of canonical ints."""
    data = p.data.detach().cpu()
    flat = data.permute(1, 0, 2).reshape(FP.nlimb, -1)
    vals = fo.decode_mont(FP, flat)
    n = p.n
    return [vals[c * n : (c + 1) * n] for c in range(data.shape[0])]


def g1_decode(p: PointBatch) -> list:
    """Batch -> host affine points (None = infinity); normalizes on device."""
    xs, ys, zs = _coords_host(normalize(p))
    return [None if z == 0 else (x, y) for x, y, z in zip(xs, ys, zs)]


def g2_decode(p: PointBatch) -> list:
    x0, x1, y0, y1, z0, z1 = _coords_host(normalize(p))
    return [
        None if (c0 == 0 and c1 == 0) else ((a0, a1), (b0, b1))
        for a0, a1, b0, b1, c0, c1 in zip(x0, x1, y0, y1, z0, z1)
    ]


def _encode_coords(cols, device) -> torch.Tensor:
    return torch.stack([fo.encode_mont(FP, c, device) for c in cols])


def g1_encode(points, device="cpu") -> PointBatch:
    """Host affine G1 points (None = infinity) -> affine-encoded batch."""
    xs = [0 if p is None else p[0] for p in points]
    ys = [0 if p is None else p[1] for p in points]
    zs = [0 if p is None else 1 for p in points]
    return PointBatch(_encode_coords([xs, ys, zs], device), "g1")


def g2_encode(points, device="cpu") -> PointBatch:
    cols = [[], [], [], [], [], []]
    for p in points:
        vals = (0, 0, 0, 0, 0, 0) if p is None else (p[0][0], p[0][1], p[1][0], p[1][1], 1, 0)
        for c, v in zip(cols, vals):
            c.append(v)
    return PointBatch(_encode_coords(cols, device), "g2")


def from_jax(point_batch, group: str, device="cpu") -> PointBatch:
    """A JAX ``PointBatch`` (16-bit limbs, as numpy or JAX arrays) -> port
    batch. G1 leaves are x, y, z; G2 leaves are (c0, c1) pairs."""
    if group == "g1":
        leaves = list(point_batch)
    else:
        leaves = [c for pair in point_batch for c in pair]
    return PointBatch(torch.stack([fo.repack16(a, device) for a in leaves]), group)


def to_jax(p: PointBatch):
    """Port batch -> the leaves of a JAX ``PointBatch`` as numpy (24, N)
    uint32 16-bit limbs, the inverse of ``from_jax``: (x, y, z) for G1,
    ((x0, x1), (y0, y1), (z0, z1)) for G2."""
    leaves = [fo.unpack16(c) for c in p.data]
    if p.group == "g1":
        return tuple(leaves)
    return tuple(tuple(leaves[i : i + 2]) for i in range(0, 6, 2))


__all__ = [
    "PointBatch", "infinity", "is_infinity", "select_point", "double", "add", "add_mixed",
    "double_plain", "add_plain", "add_mixed_plain", "normalize", "normalize_plain",
    "g1_encode", "g1_decode", "g2_encode", "g2_decode", "from_jax", "to_jax",
]
