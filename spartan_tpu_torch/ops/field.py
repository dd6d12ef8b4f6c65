"""Batched prime-field arithmetic: Montgomery form over 32-bit limbs.

Counterpart of ``spartan_tpu/ops/limb.py`` + ``spartan_tpu/ops/field.py``.
A batch of field elements is a ``(K, ...)`` ``torch.int32`` tensor, limb 0
least significant, each limb holding 32 bits (the int32 bit pattern of a
uint32). Fr has K = 8 limbs and Fp K = 12. Elements are kept canonical
(< m) and, where the protocol says so, in Montgomery form with
R = 2^(32K): 2^256 for Fr and 2^384 for Fp, the same R as the JAX package's
16-bit limbs, so a JAX limb array converts by packing limb pairs
(``repack16``).

A prover's witness is encoded by ``encode_witness`` (B of them of one
length by ``encode_witness_many``): the canonical bytes in C-level passes
on the host, one upload, and the Montgomery form on the device, one
``to_mont`` over every lane. Each call adds one to
``kernels.LANES[WITNESS_ENCODE][(lanes,)]``. The other host codecs
(``encode_mont`` and the rest) serve the few elements of challenges,
points and step rows, and the matrices' values in the index.

``add``, ``sub`` and ``mont_mul`` are the wrappers of the hand-written
kernels K1 (Fr, ``csrc/fr_ops.cu``) and K2 (Fp, ``csrc/fp_ops.cu``), and
``fermat_inv`` of K2's inversion (``csrc/fp_inv.cuh``). For a
CPU tensor they run the plain PyTorch version beside them (``*_plain``);
for a CUDA tensor they launch the kernel or raise. The plain versions split
each limb into two 16-bit halves held in ``int64`` (torch.uint32 has no
``+`` or ``>>`` on every backend), so products of halves and their sums
never overflow; they are also what the kernels are checked against on the
card.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from itertools import repeat

import numpy as np
import torch

from spartan_tpu_torch import kernels
from spartan_tpu_torch.host import field as hf

__all__ = [
    "FieldSpec", "FR", "FP",
    "add", "sub", "neg", "mont_mul", "to_mont", "from_mont",
    "pow_const", "fermat_inv", "inv", "batch_inv", "zeros", "ones_mont", "reduce_wide",
    "sum_mod", "add_plain", "sub_plain", "mont_mul_plain", "fermat_inv_plain",
    "encode_ints", "decode_ints", "encode_mont", "decode_mont", "repack16", "unpack16",
    "ints_to_limbs", "limbs_to_ints", "encode_witness", "encode_witness_many", "WITNESS_ENCODE",
]

MASK16 = 0xFFFF
WITNESS_ENCODE = "witness_encode"  # the counter of witness encodes in kernels.LANES, keyed by (lanes,)


@dataclass(frozen=True)
class FieldSpec:
    """Constants of one prime field in the 32-bit-limb layout."""

    modulus: int
    nlimb: int  # 32-bit limbs; modulus < 2^(32 * nlimb)
    name: str
    r_mod: int = dc_field(init=False, repr=False, compare=False)  # R mod m
    r_inv: int = dc_field(init=False, repr=False, compare=False)  # R^-1 mod m

    def __post_init__(self):
        r = pow(2, 32 * self.nlimb, self.modulus)
        object.__setattr__(self, "r_mod", r)
        object.__setattr__(self, "r_inv", pow(r, -1, self.modulus))

    @property
    def nsub(self) -> int:
        """Number of 16-bit sub-limbs used by the plain versions."""
        return 2 * self.nlimb


FR = FieldSpec(modulus=hf.R, nlimb=8, name="fr")
FP = FieldSpec(modulus=hf.P, nlimb=12, name="fp")


# ---------------------------------------------------------------------------
# Host codecs
# ---------------------------------------------------------------------------


def ints_to_limbs(xs, nlimb: int) -> np.ndarray:
    """Python ints (each < 2^(32 nlimb)) -> (nlimb, N) int32 limb array."""
    nb = 4 * nlimb
    buf = b"".join(int(x).to_bytes(nb, "little") for x in xs)
    arr = np.frombuffer(buf, dtype="<u4").reshape(len(xs), nlimb)
    return np.array(arr.T, dtype=np.uint32, order="C").view(np.int32)


def limbs_to_ints(arr) -> list:
    """(nlimb, N) int32 limb tensor or array -> list of Python ints."""
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().cpu().numpy()
    a = np.ascontiguousarray(np.asarray(arr).astype(np.int32).view(np.uint32).T)
    nb = 4 * a.shape[1]
    buf = a.astype("<u4").tobytes()
    return [int.from_bytes(buf[j * nb : (j + 1) * nb], "little") for j in range(a.shape[0])]


def encode_ints(spec: FieldSpec, xs, device="cpu") -> torch.Tensor:
    """ints -> canonical (not Montgomery) (K, N) limbs on ``device``."""
    m = spec.modulus
    return torch.from_numpy(ints_to_limbs([x % m for x in xs], spec.nlimb)).to(device)


def decode_ints(spec: FieldSpec, t) -> list:
    return limbs_to_ints(t)


def encode_mont(spec: FieldSpec, xs, device="cpu") -> torch.Tensor:
    """ints -> Montgomery-form (K, N) limbs (the multiply by R is on the host)."""
    m, r = spec.modulus, spec.r_mod
    return torch.from_numpy(ints_to_limbs([x % m * r % m for x in xs], spec.nlimb)).to(device)


def encode_witness(spec: FieldSpec, xs, device="cpu") -> torch.Tensor:
    """A whole witness: ints -> Montgomery-form (K, N) limbs on ``device``,
    equal to ``encode_mont``'s. See ``encode_witness_many``."""
    return encode_witness_many(spec, [xs], device)[0]


def encode_witness_many(spec: FieldSpec, xss, device="cpu") -> torch.Tensor:
    """B witnesses of one length N: ints -> Montgomery-form (B, K, N) limbs
    on ``device``, equal to the stack of ``encode_mont`` of each.

    The host writes x mod m of every x as 4K little-endian bytes into one
    buffer (pinned where the device is a card), a witness at a time, each
    in C-level passes with no Python loop body (``_canonical_bytes``). The
    buffer goes up in one copy as (B, N, K) words; the device turns them to
    (K, B, N), multiplies all B N lanes by R^2 in one ``to_mont`` (one
    ``fr_mul`` launch on a card, the plain version on the CPU) and copies
    the result into the (B, K, N) table. Counted under WITNESS_ENCODE by
    B N lanes."""
    bsz, n, k = len(xss), len(xss[0]), spec.nlimb
    if any(len(xs) != n for xs in xss[1:]):
        raise ValueError("witnesses of one length expected")
    kernels.LANES[WITNESS_ENCODE][(bsz * n,)] += 1
    dev = torch.device(device)
    # the result is allocated first: the temporaries after it are all freed
    # here, so the allocator's cache is left as the one table would leave it
    z = torch.empty((bsz, k, n), dtype=torch.int32, device=dev)
    host = torch.empty(bsz * n * k, dtype=torch.int32, pin_memory=dev.type == "cuda")
    raw = host.numpy().view(np.uint8).reshape(bsz, n * 4 * k)
    for b, xs in enumerate(xss):  # a witness a pass: its objects stay in the caches
        raw[b] = np.frombuffer(_canonical_bytes(xs, spec.modulus, 4 * k), np.uint8)
    canon = host.to(dev, non_blocking=True).view(bsz, n, k).permute(2, 0, 1).contiguous()
    z.copy_(to_mont(spec, canon).transpose(0, 1))  # (K, B, N) -> (B, K, N)
    return z


def _canonical_bytes(xs, m: int, nb: int) -> bytes:
    """x mod m of every x in ``xs`` as ``nb`` little-endian bytes, joined.
    The reduction runs over a witness with some x outside [0, m); in any
    other x mod m is x, and a pass of comparisons (``min``, ``max``) costs
    less than the division."""
    if min(xs) < 0 or max(xs) >= m:
        xs = map(int.__mod__, xs, repeat(m))
    return b"".join(map(int.to_bytes, xs, repeat(nb), repeat("little")))


def decode_mont(spec: FieldSpec, t) -> list:
    m, rinv = spec.modulus, spec.r_inv
    return [x * rinv % m for x in limbs_to_ints(t)]


def repack16(arr16, device="cpu") -> torch.Tensor:
    """JAX layout (2K, ...) uint32 16-bit limbs -> port layout (K, ...) int32.

    l32[i] = l16[2i] | l16[2i+1] << 16. R is 2^(16 * 2K) = 2^(32K) in both
    layouts, so Montgomery values need nothing more."""
    a = np.asarray(arr16).astype(np.uint32)
    if a.shape[0] % 2:
        raise ValueError("16-bit limb count must be even")
    packed = (a[0::2] | (a[1::2] << 16)).astype(np.uint32)
    return torch.from_numpy(np.ascontiguousarray(packed).view(np.int32)).to(device)


def unpack16(t: torch.Tensor) -> np.ndarray:
    """Port layout (K, ...) int32 -> JAX layout (2K, ...) uint32 16-bit
    limbs, the inverse of ``repack16``: l16[2i] = l32[i] & 0xFFFF,
    l16[2i+1] = l32[i] >> 16."""
    a = t.detach().cpu().numpy().view(np.uint32)
    out = np.empty((2 * a.shape[0],) + a.shape[1:], dtype=np.uint32)
    out[0::2] = a & MASK16
    out[1::2] = a >> 16
    return out


# ---------------------------------------------------------------------------
# Plain-PyTorch machinery: int64 tensors of 16-bit sub-limbs
# ---------------------------------------------------------------------------

_CONST_CACHE: dict = {}


def _sub16_of(x: int, n: int) -> list:
    out = []
    for _ in range(n):
        out.append(x & MASK16)
        x >>= 16
    if x:
        raise ValueError("value does not fit")
    return out


def _consts(spec: FieldSpec, device) -> dict:
    """Per-device int64 constant columns for the plain versions."""
    key = (spec.name, str(device))
    c = _CONST_CACHE.get(key)
    if c is None:
        L, m = spec.nsub, spec.modulus
        big_r = 1 << (16 * L)
        q = big_r // m  # a value < 2^(16L) is < (q + 1) m
        col = lambda vals: torch.tensor(vals, dtype=torch.int64, device=device)[:, None]
        c = {
            "m": col(_sub16_of(m, L + 1)),
            "mprime": col(_sub16_of((-pow(m, -1, big_r)) % big_r, L)),
            "fold": torch.tensor(
                [_sub16_of(pow(2, 16 * (L + t), m), L) for t in range(4)],
                dtype=torch.int64, device=device,
            ),  # (4, L): 2^(16(L+t)) mod m
            "mshift": [col(_sub16_of(m << j, L + 1)) for j in range(q.bit_length())],
        }
        _CONST_CACHE[key] = c
    return c


def _to16(a: torch.Tensor) -> torch.Tensor:
    """(K, ...) int32 limbs -> (2K, ...) int64 16-bit sub-limbs."""
    v = a.to(torch.int64) & 0xFFFFFFFF
    return torch.stack([v & MASK16, v >> 16], dim=1).reshape((2 * a.shape[0],) + a.shape[1:])


def _to32(x: torch.Tensor) -> torch.Tensor:
    """(2K, ...) int64 exact 16-bit sub-limbs -> (K, ...) int32 limbs."""
    v = x[0::2] | (x[1::2] << 16)
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


def _zrows(x: torch.Tensor, k: int) -> torch.Tensor:
    return torch.zeros((k,) + x.shape[1:], dtype=x.dtype, device=x.device)


def _carry(x: torch.Tensor) -> torch.Tensor:
    """Exact carry propagation along dim 0. Every limb but the top ends in
    [0, 2^16); the top limb keeps the rest of the value (it may be negative
    or exceed 2^16), so the represented integer is unchanged."""
    while True:
        hi = x[:-1] >> 16
        if not bool(hi.any()):
            return x
        x = _split(x, keep_top=True, hi=hi)


def _split(x: torch.Tensor, keep_top: bool, hi=None) -> torch.Tensor:
    """One lazy carry pass along dim 0: limb i keeps its low 16 bits and
    passes the rest up. ``keep_top`` keeps the top limb whole (the value is
    unchanged); otherwise its carry is dropped (the value is taken mod
    2^(16 J))."""
    if hi is None:
        hi = x[:-1] >> 16
    out = x & MASK16
    if keep_top:
        out[-1] = x[-1]
    out[1:] += hi
    return out


def _conv(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Limb convolution: (La, ...) x (Lb, ...) -> (La + Lb - 1, ...).

    Small batches write the outer product into a zero buffer whose rows are
    re-read with stride La + Lb - 1 (row i shifted right by i) and summed:
    few calls. Large batches accumulate La shifted row products instead,
    which never holds the La x (La + Lb) buffer."""
    la, lb = a.shape[0], b.shape[0]
    ra, rb = a.shape[1:], b.shape[1:]
    if ra == rb or (len(ra) == len(rb) and all(d == 1 for d in rb)):  # skips broadcast_shapes' cost
        rest = ra
    else:
        rest = torch.broadcast_shapes(ra, rb)
    lanes = 1
    for d in rest:
        lanes *= d
    if lanes * la * lb <= 1 << 18:
        buf = torch.zeros((la, la + lb) + rest, dtype=torch.int64, device=a.device)
        torch.mul(a[:, None], b[None], out=buf[:, :lb])
        flat = buf.reshape((la * (la + lb),) + rest)
        return flat[: la * (la + lb - 1)].reshape((la, la + lb - 1) + rest).sum(0)
    out = torch.zeros((la + lb - 1,) + rest, dtype=torch.int64, device=a.device)
    b = b.expand((lb,) + rest)
    for i in range(la):
        out[i : i + lb].addcmul_(b, a[i])
    return out


def _cond_sub(x: torch.Tensor, mcol: torch.Tensor) -> torch.Tensor:
    """x - m if x >= m else x, for exact limbs x (J, ...) and m (J, 1)."""
    d = _carry(x - mcol.reshape((-1,) + (1,) * (x.dim() - 1)))
    return torch.where(d[-1:] < 0, x, d)


def _col(t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return t.reshape((-1,) + (1,) * (x.dim() - 1))


def mont_mul_plain(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b * R^-1 mod m: schoolbook product T, then a full-width Montgomery
    reduction, mm = (T mod R) m' mod R and (T + mm m) / R, and one
    conditional subtract. Canonical in and out.

    Only the last step needs exact limbs: two lazy carry passes bring every
    limb below 2^16 + 2^7, which keeps the next product in int64 and mm
    below 1.003 R, so (T + mm m) / R < 2m. The low half of
    T + mm m is then a multiple of R below 2R: its carry into the high half
    is 1 exactly when some low limb is non-zero."""
    c = _consts(spec, a.device)
    L = spec.nsub
    t = _conv(_to16(a), _to16(b))  # (2L-1, ...), entries < L * 2^32
    lo = t[:L]
    for _ in range(2):
        lo = _split(lo, keep_top=False)  # == T mod R, limbs < 2^16 + 2^5
    mm = _conv(lo, _col(c["mprime"], lo))[:L]
    for _ in range(2):
        mm = _split(mm, keep_top=False)  # limbs < 2^16 + 2^7
    u = torch.cat([t, _zrows(t, 2)]) + torch.cat([_conv(mm, _col(c["m"][:L], mm)), _zrows(t, 2)])
    for _ in range(2):
        u = _split(u, keep_top=True)
    k = (u[:L] != 0).any(0, keepdim=True).to(torch.int64)
    u = u[L:]
    u = _carry(torch.cat([u[:1] + k, u[1:]]))  # (T + mm m) / R, exact, < 2m
    return _to32(_cond_sub(u, c["m"])[:L])


def add_plain(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    c = _consts(spec, a.device)
    s = _to16(a) + _to16(b)
    s = _carry(torch.cat([s, _zrows(s, 1)]))
    return _to32(_cond_sub(s, c["m"])[: spec.nsub])


def sub_plain(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    c = _consts(spec, a.device)
    d = _to16(a) - _to16(b)
    d = _carry(torch.cat([d, _zrows(d, 1)]))
    d2 = _carry(d + _col(c["m"], d))
    return _to32(torch.where(d[-1:] < 0, d2, d)[: spec.nsub])


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _binary(op: str, plain, spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    if a.shape[0] != spec.nlimb:
        raise ValueError(f"{spec.name}: expected {spec.nlimb} limbs, got {a.shape[0]}")
    if a.device.type == "cpu" and b.device.type == "cpu":
        return plain(spec, a, b)
    shape = a.shape
    a2 = a.reshape(spec.nlimb, -1).contiguous()
    b2 = b.reshape(spec.nlimb, -1).contiguous()
    out = torch.empty_like(a2)
    kernels.launch(f"{spec.name}_{op}", out, a2, b2)
    return out.reshape(shape)


def mont_mul(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a * b * R^-1) mod m, canonical in and out; broadcasts like torch."""
    return _binary("mul", mont_mul_plain, spec, a, b)


def add(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _binary("add", add_plain, spec, a, b)


def sub(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _binary("sub", sub_plain, spec, a, b)


# ---------------------------------------------------------------------------
# Derived operations
# ---------------------------------------------------------------------------


def zeros(spec: FieldSpec, batch_shape=(), device="cpu") -> torch.Tensor:
    return torch.zeros((spec.nlimb,) + tuple(batch_shape), dtype=torch.int32, device=device)


def ones_mont(spec: FieldSpec, batch_shape=(), device="cpu") -> torch.Tensor:
    col = torch.from_numpy(ints_to_limbs([spec.r_mod], spec.nlimb)).to(device)
    col = col.reshape((spec.nlimb,) + (1,) * len(batch_shape))
    return col.expand((spec.nlimb,) + tuple(batch_shape)).contiguous()


def neg(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    return sub(spec, torch.zeros_like(a), a)


def to_mont(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    r2 = encode_ints(spec, [spec.r_mod * spec.r_mod % spec.modulus], a.device)
    return mont_mul(spec, a, r2.reshape((spec.nlimb,) + (1,) * (a.dim() - 1)))


def from_mont(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    one = encode_ints(spec, [1], a.device)
    return mont_mul(spec, a, one.reshape((spec.nlimb,) + (1,) * (a.dim() - 1)))


def pow_const(spec: FieldSpec, a: torch.Tensor, e: int, mul=None) -> torch.Tensor:
    """Batched a^e for a public exponent, Montgomery form: square and
    multiply, MSB first. ``mul`` defaults to the field's kernel wrapper."""
    mul = mul or (lambda x, y: mont_mul(spec, x, y))
    result = ones_mont(spec, a.shape[1:], a.device)
    for bit in bin(e)[2:]:
        result = mul(result, result)
        if bit == "1":
            result = mul(result, a)
    return result


def fermat_inv_plain(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """a^(m-2) per lane, Montgomery form (inv(0) = 0): the square-and-multiply
    chain over ``mont_mul_plain``."""
    return pow_const(spec, a, spec.modulus - 2, lambda x, y: mont_mul_plain(spec, x, y))


def fermat_inv(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """a^(m-2) per lane, Montgomery form (inv(0) = 0). Fp on the card is one
    launch of K2's ``fp_inv``, the whole chain; Fr on the card is the chain
    over the ``fr_mul`` kernel. A CPU tensor takes the plain chain."""
    if a.shape[0] != spec.nlimb:
        raise ValueError(f"{spec.name}: expected {spec.nlimb} limbs, got {a.shape[0]}")
    if a.device.type == "cpu":
        return fermat_inv_plain(spec, a)
    if spec is not FP:
        return pow_const(spec, a, spec.modulus - 2)
    a2 = a.reshape(spec.nlimb, -1).contiguous()
    out = torch.empty_like(a2)
    kernels.launch("fp_inv", out, a2)
    return out.reshape(a.shape)


def inv(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """Batched inverse of (K, ...) Montgomery elements; inv(0) = 0."""
    return batch_inv(spec, a, lambda x, y: mont_mul(spec, x, y), lambda x: fermat_inv(spec, x))


def batch_inv(spec: FieldSpec, a: torch.Tensor, mul, root_inv) -> torch.Tensor:
    """``inv`` with the multiply ``mul`` and the inversion ``root_inv`` of
    the tree's root (kernel wrappers or plain versions).

    Montgomery's trick over a product tree: multiply lanes pairwise up to
    one product, invert it by Fermat (a^(m-2)), and walk back down, two
    stacked products per level: 2 log2(N) wide multiplies instead of a
    Fermat ladder over every lane. Zero lanes are set to one on the way up
    and to zero at the end."""
    shape = a.shape
    a = a.reshape(spec.nlimb, -1)
    zero = (a == 0).all(0)
    one = ones_mont(spec, (1,), a.device)
    level = torch.where(zero, one, a)
    levels = []
    while level.shape[1] > 1:
        if level.shape[1] % 2:
            level = torch.cat([level, one], dim=1)
        levels.append(level)
        level = mul(level[:, 0::2], level[:, 1::2])
    result = root_inv(level)
    for lv in reversed(levels):
        # inv(even) = inv(parent) odd and inv(odd) = inv(parent) even
        pair = torch.stack([lv[:, 1::2], lv[:, 0::2]], dim=2)  # (K, P, 2)
        parents = result[:, : pair.shape[1], None]  # drop a padding lane
        result = mul(parents, pair).reshape(spec.nlimb, -1)
    result = result[:, : a.shape[1]]
    return torch.where(zero, torch.zeros_like(result), result).reshape(shape)


def reduce_wide(spec: FieldSpec, acc: torch.Tensor) -> torch.Tensor:
    """Reduce wide sums mod m: ``acc`` is (J, ...) int64, non-negative, with
    value sum_j acc[j] 2^(16 j) (16-bit positions, any magnitudes below
    2^47). Returns canonical (K, ...) int32 limbs in the domain the summands
    were in (a sum of Montgomery values stays Montgomery).

    Counterpart of ``spartan_tpu/ops/field.py:342``: limbs above the field
    width fold back through the table 2^(16(L+t)) mod m until nothing is
    left above it, then a ladder of conditional subtracts of m << j lands
    in [0, m)."""
    c = _consts(spec, acc.device)
    L = spec.nsub
    x = _carry(torch.cat([acc, _zrows(acc, 3)]))
    while x.shape[0] > L and bool(x[L:].any()):
        top = x[L:]
        fold = c["fold"]
        while fold.shape[0] < top.shape[0]:
            t = fold.shape[0]
            fold = torch.cat([fold, torch.tensor(
                [_sub16_of(pow(2, 16 * (L + t), spec.modulus), L)],
                dtype=torch.int64, device=acc.device)])
        f = fold[: top.shape[0]].reshape(top.shape[:1] + (L,) + (1,) * (top.dim() - 1))
        low = x[:L] + (f * top[:, None]).sum(0)
        x = _carry(torch.cat([low, _zrows(low, 3)]))
    x = torch.cat([x[:L], _zrows(x, 1)])
    for mcol in reversed(c["mshift"]):
        x = _cond_sub(x, mcol)
    return _to32(x[:L])


def sum_mod(table: torch.Tensor) -> torch.Tensor:
    """Fr sum over the last axis: (8, ..., N) -> (8, ..., 1) canonical.

    The 16-bit halves are summed in int64 (exact below 2^47 terms), then
    reduced once (``spartan_tpu/ops/mle.py:142``)."""
    return reduce_wide(FR, _to16(table).sum(-1, keepdim=True))
