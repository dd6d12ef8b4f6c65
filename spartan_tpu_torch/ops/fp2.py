"""Batched Fp2 = Fp[u]/(u^2 + 1) arithmetic on top of the port's Fp.

Counterpart of ``spartan_tpu/ops/fp2.py``. An Fp2 batch is one
``(12, 2, ...)`` int32 tensor: ``a[:, 0]`` is c0 and ``a[:, 1]`` is c1, both
Montgomery Fp. Keeping both components in one tensor lets every Fp2 add or
sub be one Fp call and every multiply one Fp call over three stacked
products (Karatsuba), which matters for the plain versions, whose cost is
per call.

Each function takes the base-field operations ``f`` it runs on, ``PLAIN``
(the plain PyTorch versions) by default: the point kernels' plain versions
and ``curve.normalize_plain`` run on it. ``inv`` is the Fermat inversion of
one batch. On the card the point kernels and ``curve.normalize`` do their
Fp2 arithmetic inside their own launches.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple

import torch

from spartan_tpu_torch.ops import field as fo
from spartan_tpu_torch.ops.field import FP


class FpOps(NamedTuple):
    add: Callable
    sub: Callable
    mul: Callable
    inv: Callable


PLAIN = FpOps(partial(fo.add_plain, FP), partial(fo.sub_plain, FP), partial(fo.mont_mul_plain, FP),
              partial(fo.fermat_inv_plain, FP))


def make(c0: torch.Tensor, c1: torch.Tensor) -> torch.Tensor:
    return torch.stack([c0, c1], dim=1)


def add2(a, b, f: FpOps = PLAIN):
    return f.add(a, b)


def sub2(a, b, f: FpOps = PLAIN):
    return f.sub(a, b)


def mul2(a, b, f: FpOps = PLAIN):
    """Karatsuba: t0 = a0 b0, t1 = a1 b1, t2 = (a0 + a1)(b0 + b1);
    c0 = t0 - t1, c1 = t2 - t0 - t1. The three products are one call."""
    a, b = torch.broadcast_tensors(a, b)
    ab = torch.stack([a, b], dim=1)  # (12, 2 [a|b], 2 [c0|c1], ...)
    sums = f.add(ab[:, :, 0], ab[:, :, 1])  # a0 + a1, b0 + b1
    lhs = torch.cat([a, sums[:, 0:1]], dim=1)
    rhs = torch.cat([b, sums[:, 1:2]], dim=1)
    t = f.mul(lhs, rhs)  # t0, t1, t2
    t01 = f.add(t[:, 0:1], t[:, 1:2])
    return f.sub(torch.cat([t[:, 0:1], t[:, 2:3]], dim=1), torch.cat([t[:, 1:2], t01], dim=1))


def sq2(a, f: FpOps = PLAIN):
    """(a0 + a1)(a0 - a1) + 2 a0 a1 u, two products in one call."""
    a0, a1 = a[:, 0], a[:, 1]
    lhs = torch.stack([f.add(a0, a1), a0], dim=1)
    rhs = torch.stack([f.sub(a0, a1), a1], dim=1)
    t = f.mul(lhs, rhs)
    return make(t[:, 0], f.add(t[:, 1], t[:, 1]))


def inv2(a, f: FpOps = PLAIN):
    """Batched inverse conj(a) / (a0^2 + a1^2); inv2(0) = 0."""
    sq = f.mul(a, a)
    norm = f.add(sq[:, 0], sq[:, 1])
    n_inv = fo.batch_inv(FP, norm, f.mul, f.inv)
    conj = make(a[:, 0], f.sub(torch.zeros_like(a[:, 1]), a[:, 1]))
    return f.mul(conj, n_inv[:, None])
