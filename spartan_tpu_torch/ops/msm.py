"""Multi-scalar multiplication: bucket-method Pippenger and fixed-base.

Counterpart of ``spartan_tpu/ops/msm.py`` (``signed_digits`` :61, ``msm``
:401 / ``msm_pippenger`` :418, ``msm_many`` :509 / ``msm_many_pippenger``
:529, ``fixed_base_msm`` :631, ``fixed_base_table_device`` :680). Affine
results are unique, so this structure, which differs from the JAX one,
gives the same proof bytes. All point work goes through the point kernels
(``curve.add_mixed``/``add``/``double``); sorting, gathers and index
bookkeeping are plain PyTorch.

Variable-base pipeline, for L problems at once:

1. signed c-bit digits in [-2^(c-1), 2^(c-1)) (``signed_digits``);
2. one ``torch.sort`` of the composite keys (problem, window, |digit| - 1)
   of the non-zero digits, and a gather of the bases in that order, with y
   negated for negative digits;
3. bucket sums by pairwise merges inside each run of equal keys: one
   mixed add for the first level (the bases are affine), full adds after,
   ceil(log2(longest run)) levels;
4. the weighted bucket sum sum_b (b + 1) S_b of every window by a pair
   tree (``_weighted_reduce``);
5. Horner across windows, batched over the L problems: c doublings per
   window, one double launch with k = c.
"""

from __future__ import annotations

from typing import Sequence

import torch

from spartan_tpu_torch import kernels
from spartan_tpu_torch.ops import curve as cv
from spartan_tpu_torch.ops import field as fo
from spartan_tpu_torch.ops.curve import PointBatch
from spartan_tpu_torch.ops.field import FP, FR

__all__ = [
    "signed_digits", "default_window", "msm", "msm_many", "fixed_base_msm",
    "fixed_base_table_device",
]

SCALAR_BITS = 256


def default_window(n: int) -> int:
    """Window width for an n-point MSM (c divides 32)."""
    return 4 if n < 4096 else 8


def _scalar_int64(scalars: torch.Tensor) -> torch.Tensor:
    return scalars.to(torch.int64) & 0xFFFFFFFF


def digits_from_limbs(scalars: torch.Tensor, c: int) -> torch.Tensor:
    """(8, N) canonical 32-bit limbs -> (256 / c, N) unsigned c-bit digits,
    least significant window first."""
    if 32 % c:
        raise ValueError("window width must divide 32")
    per = 32 // c
    v = _scalar_int64(scalars)
    shifts = torch.arange(per, device=v.device, dtype=torch.int64) * c
    return ((v[:, None, :] >> shifts[None, :, None]) & ((1 << c) - 1)).reshape(-1, v.shape[1])


def signed_digits(scalars: torch.Tensor, c: int):
    """Signed c-bit recoding of canonical Fr scalars (< 2^255).

    Digits lie in [-H, H - 1] with H = 2^(c-1), except the top window, which
    lies in [0, H]. They are the unsigned digits of s + sum_{w < top} H 2^(c w)
    minus H, which is the same recoding as a carry chain over the windows.
    Returns (digits (nw, N) int64, in [-H, H])."""
    nw = SCALAR_BITS // c
    half = 1 << (c - 1)
    offset = sum(half << (c * w) for w in range(nw - 1))
    off = fo.ints_to_limbs([offset], FR.nlimb)
    v = _scalar_int64(scalars) + _scalar_int64(torch.from_numpy(off).to(scalars.device))
    for i in range(FR.nlimb - 1):  # carry the 33-bit limb sums
        v[i + 1] += v[i] >> 32
        v[i] &= 0xFFFFFFFF
    per = 32 // c
    shifts = torch.arange(per, device=v.device, dtype=torch.int64) * c
    d = ((v[:, None, :] >> shifts[None, :, None]) & ((1 << c) - 1)).reshape(nw, -1)
    d[:-1] -= half
    return d


def _neg_y(p: PointBatch, mask: torch.Tensor) -> PointBatch:
    """Negate y on the masked lanes (p - y via the Fp kernel; 0 stays 0)."""
    data = p.data
    ys = data[1:2] if p.group == "g1" else data[2:4]
    ny = fo.sub(FP, torch.zeros_like(ys).permute(1, 0, 2), ys.permute(1, 0, 2)).permute(1, 0, 2)
    ys_new = torch.where(mask, ny, ys)
    if p.group == "g1":
        out = torch.cat([data[0:1], ys_new, data[2:3]])
    else:
        out = torch.cat([data[0:2], ys_new, data[4:6]])
    return PointBatch(out, p.group)


def _bucket_sums(pts: PointBatch, keys: torch.Tensor):
    """Sum the points of every run of equal (sorted) keys.

    Each level merges positions 2j and 2j+1 of every run; a run of length l
    becomes ceil(l / 2). Returns (distinct keys, one point per run)."""
    uniq, counts = torch.unique_consecutive(keys, return_counts=True)
    dev = keys.device
    nseg = uniq.shape[0]
    seg = torch.repeat_interleave(torch.arange(nseg, device=dev), counts)
    lens = counts
    first = True
    while int(lens.max()) > 1:
        starts = torch.cumsum(lens, 0) - lens
        pos = torch.arange(seg.shape[0], device=dev) - starts[seg]
        even = (pos % 2) == 0
        paired = even & (pos + 1 < lens[seg])
        left = torch.nonzero(paired).squeeze(1)
        merge = cv.add_mixed if first else cv.add
        sums = merge(pts.take(left), pts.take(left + 1))
        keep = torch.nonzero(even).squeeze(1)
        data = pts.data.index_select(2, keep)
        new_pos = torch.cumsum(even.to(torch.int64), 0) - 1
        data[..., new_pos[left]] = sums.data
        pts = PointBatch(data, pts.group)
        seg = seg[keep]
        lens = (lens + 1) // 2
        first = False
    return uniq, pts


def _weighted_reduce(buckets: PointBatch, bsz: int) -> PointBatch:
    """Per-window sum_b (b + 1) S_b over (nwin * bsz) window-major buckets,
    bsz a power of two. Pair-halving tree (``spartan_tpu/ops/msm.py:229``):
    with S'_j = S_2j + S_2j+1 and U the odd-lane sum of a level,
    V(S) = 2 V(S') - Tot + U, which unrolls to V = Tot + sum_k 2^k U_k."""
    us = []
    t = buckets
    m = bsz
    while m > 1:
        e, o = t.take(slice(0, None, 2)), t.take(slice(1, None, 2))
        t = cv.add(e, o)
        us.append(o)
        m //= 2
    tot = t
    nwin = tot.n
    ubars = []
    for u in us:
        while u.n > nwin:
            u = cv.add(u.take(slice(0, None, 2)), u.take(slice(1, None, 2)))
        ubars.append(u)
    if not ubars:
        return tot
    acc = ubars[-1]
    for u in reversed(ubars[:-1]):
        acc = cv.add(cv.double(acc), u)
    return cv.add(tot, acc)


def msm_many(points: PointBatch, sizes: Sequence[int], scalars: torch.Tensor, c: int = None) -> PointBatch:
    """L independent MSMs in one pass.

    points: affine-encoded bases, the L problems' bases concatenated
    (sum(sizes) lanes). scalars: (8, sum(sizes)) canonical Fr limbs.
    Returns one Jacobian point per problem (a batch of L lanes)."""
    sizes = [int(s) for s in sizes]
    n = sum(sizes)
    if points.n != n or scalars.shape[1] != n:
        raise ValueError("points, scalars and sizes disagree")
    c = default_window(n) if c is None else c
    dev = points.device
    L = len(sizes)
    nw = SCALAR_BITS // c
    half = 1 << (c - 1)

    digits = signed_digits(scalars, c)  # (nw, n)
    pid = torch.repeat_interleave(
        torch.arange(L, device=dev), torch.tensor(sizes, device=dev))
    w_ids = torch.arange(nw, device=dev)[:, None]
    keys = (pid[None, :] * nw + w_ids) * half + digits.abs() - 1  # (nw, n)
    nz = torch.nonzero(digits.reshape(-1) != 0).squeeze(1)
    keys = keys.reshape(-1)[nz]
    keys, order = torch.sort(keys)
    lane = nz[order]
    bases = points.take(lane % n)
    bases = _neg_y(bases, (digits.reshape(-1)[lane] < 0))

    buckets = cv.infinity(points.group, L * nw * half, dev)
    if keys.numel():
        uniq, sums = _bucket_sums(bases, keys)
        buckets.data[..., uniq] = sums.data
    wsums = _weighted_reduce(buckets, half)  # (L * nw) lanes, problem-major
    wsums = wsums.data.reshape(wsums.data.shape[:2] + (L, nw))

    result = cv.infinity(points.group, L, dev)
    for w in range(nw - 1, -1, -1):
        if w != nw - 1:
            result = cv.double(result, c)
        result = cv.add(result, PointBatch(wsums[..., w].contiguous(), points.group))
    return result


def msm(points: PointBatch, scalars: torch.Tensor, c: int = None) -> PointBatch:
    """sum_i scalars[i] * points[i]; one Jacobian point (a batch of 1)."""
    return msm_many(points, [points.n], scalars, c)


def fixed_base_table_device(base_pt, ops, encode, c: int = 8, device="cuda") -> PointBatch:
    """Window table of a fixed base G: entry w * 2^c + d is d * 2^(c w) * G,
    on ``device`` (the card unless the caller names another).

    The host gives the 256 doublings 2^j G (Python integers); the entries
    assemble on the device with one masked batched add per digit bit
    (``spartan_tpu/ops/msm.py:680``). Returns a Jacobian batch."""
    device = kernels.require_device(device)
    nw = SCALAR_BITS // c
    doubles = []
    p = base_pt
    for _ in range(SCALAR_BITS):
        doubles.append(p)
        p = ops.double(p)
    dbl = encode(doubles, device)  # (.., 256): 2^j G, z = 1
    n = nw << c
    digit = torch.arange(n, device=device) & ((1 << c) - 1)
    window = torch.arange(n, device=device) >> c
    acc = cv.infinity(dbl.group, n, device)
    for j in range(c):
        g = dbl.take(window * c + j)
        cand = cv.add(acc, g)
        acc = cv.select_point(((digit >> j) & 1) > 0, cand, acc)
    return acc


def fixed_base_msm(table: PointBatch, scalars: torch.Tensor, c: int = 8) -> PointBatch:
    """out[i] = scalars[i] * G from an affine-encoded window table
    (``fixed_base_table_device``, normalized): the nw table entries of every
    lane are gathered and summed by a pair tree, mixed adds on the first
    level (both sides affine), full adds after."""
    digits = digits_from_limbs(scalars, c)  # (nw, N)
    nw, n = digits.shape
    idx = torch.arange(nw, device=digits.device)[:, None] * (1 << c) + digits
    terms = table.take(idx.reshape(-1))  # window-major: lane w * N + i
    first = True
    while terms.n > n:
        half = terms.n // 2  # nw is a power of two: windows pair up exactly
        merge = cv.add_mixed if first else cv.add
        terms = merge(terms.take(slice(0, half)), terms.take(slice(half, None)))
        first = False
    return terms
