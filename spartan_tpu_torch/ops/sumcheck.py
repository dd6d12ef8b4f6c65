"""Sumcheck rounds: fold by the incoming challenge, then evaluate.

Counterpart of ``spartan_tpu/ops/sumcheck.py`` (``sc1_round`` :77,
``prod2_round`` :97), without the fixed-width tail padding that existed for
XLA compile cost.

The rounds here return the evaluations at t = 0, 1, 2 as an (8, 3)
Montgomery tensor, from the Fr kernels K1 (one launch an operation, a
reduction an evaluation) on the card; the host-transcript route decodes them
every round. ``PLAIN`` runs a round on the plain versions of the field
operations on any device: the device-resident phases (``protocol/fused.py``)
take it on CPU tensors, and their kernels K6 and K7 are held against it.
"""

from __future__ import annotations

from functools import partial

import torch

from spartan_tpu_torch.ops import field as fo
from spartan_tpu_torch.ops.field import FR


class FrOps:
    """Fr add, sub and Montgomery product, and the fold built from them."""

    def __init__(self, add, sub, mul):
        self.add, self.sub, self.mul = add, sub, mul

    def fold(self, table: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
        """out[b] = t[2b] + r (t[2b+1] - t[2b]), as ``mle.fold``."""
        even, odd = _halves(table)
        return self.add(even, self.mul(self.sub(odd, even), r.reshape(FR.nlimb, 1)))


K1 = FrOps(partial(fo.add, FR), partial(fo.sub, FR), partial(fo.mont_mul, FR))
PLAIN = FrOps(partial(fo.add_plain, FR), partial(fo.sub_plain, FR), partial(fo.mont_mul_plain, FR))


def _halves(tab):
    return tab[..., 0::2], tab[..., 1::2]


def sc1_evals3(az, bz, cz, s_table, ops: FrOps = K1) -> torch.Tensor:
    """sum_b S[b] (Az_t Bz_t - Cz_t)[b] at t = 0, 1, 2."""
    abc = torch.stack([az, bz, cz], dim=1)  # (8, 3, N)
    e, o = _halves(abc)
    d = ops.sub(o, e)
    outs = []
    cur = e
    for t in range(3):
        if t > 0:
            cur = ops.add(cur, d)
        val = ops.sub(ops.mul(cur[:, 0], cur[:, 1]), cur[:, 2])
        outs.append(fo.sum_mod(ops.mul(val, s_table)))
    return torch.cat(outs, dim=1)


def sc1_round(az, bz, cz, s_table, do_fold: bool, r, ops: FrOps = K1):
    """One Spartan sumcheck-1 round: optional fold by r, then the inner
    quadratic. Returns ((8, 3) evals, az', bz', cz')."""
    if do_fold:
        folded = ops.fold(torch.stack([az, bz, cz], dim=1).reshape(FR.nlimb, -1), r)
        n = az.shape[-1] // 2
        az, bz, cz = folded[:, :n], folded[:, n : 2 * n], folded[:, 2 * n :]
    return sc1_evals3(az, bz, cz, s_table, ops), az, bz, cz


def prod2_evals3(w, z, ops: FrOps = K1) -> torch.Tensor:
    """Degree-2 round evaluations of sum_b w(t, b) z(t, b) at t = 0, 1, 2."""
    wz = torch.stack([w, z], dim=1)
    e, o = _halves(wz)
    d = ops.sub(o, e)
    outs = []
    cur = e
    for t in range(3):
        if t > 0:
            cur = ops.add(cur, d)
        outs.append(fo.sum_mod(ops.mul(cur[:, 0], cur[:, 1])))
    return torch.cat(outs, dim=1)


def prod2_round(w, z, do_fold: bool, r, ops: FrOps = K1):
    """One degree-2 round for sum_b w(t, b) z(t, b)."""
    if do_fold:
        n = w.shape[-1] // 2
        folded = ops.fold(torch.cat([w, z], dim=1), r)
        w, z = folded[:, :n], folded[:, n:]
    return prod2_evals3(w, z, ops), w, z
