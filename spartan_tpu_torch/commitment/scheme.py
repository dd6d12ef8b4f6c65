"""PST/Libra-style multilinear polynomial commitment: keygen, commit, open,
verify.

Counterpart of ``spartan_tpu/commitment/scheme.py``:

- ``keygen`` (:88) samples g, h and the trapdoor t from the caller's
  ``sample_fr()`` stream in the same order (g, h, then t), so the same
  stream gives the same keys; the hypercubes g^{eq(t[i..], b)} come from the
  eq suffix tables and the fixed-base MSM on ``device``.
- ``commit`` (:160) is one G1 MSM of the evaluation table.
- ``open_poly`` (:266) builds the per-variable quotient tables and the
  evaluation (``_quotients_and_eval`` :175) and commits every quotient with
  a G2 MSM over the pairwise-combined bases (``banded_g2_msms`` :203).
- ``verify`` (:306) is the host pairing-product check.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from spartan_tpu_torch import kernels
from spartan_tpu_torch.commitment.data_structures import (
    Commitment, OpenProof, PublicParameter, VerifierParameter,
)
from spartan_tpu_torch.host import curve as hc
from spartan_tpu_torch.host import field as hf
from spartan_tpu_torch.host import pairing as hp
from spartan_tpu_torch.ops import curve as cv
from spartan_tpu_torch.ops import field as fo
from spartan_tpu_torch.ops import mle
from spartan_tpu_torch.ops import msm as msm_mod
from spartan_tpu_torch.ops.curve import PointBatch
from spartan_tpu_torch.ops.field import FR
from spartan_tpu_torch.timers import span
from spartan_tpu_torch.utils.errors import invalid_arg


def _split_levels(batch: PointBatch, sizes: List[int]) -> List[PointBatch]:
    out, off = [], 0
    for s in sizes:
        out.append(PointBatch(batch.data[..., off : off + s].contiguous(), batch.group))
        off += s
    return out


def _combine_pairs_g2(pb: PointBatch) -> PointBatch:
    """comb[j] = P[2j] + P[2j+1] (Jacobian), the opening MSM's bases."""
    return cv.add(pb.take(slice(0, None, 2)), pb.take(slice(1, None, 2)))


def keygen(nv: int, rng, device="cuda") -> Tuple[PublicParameter, VerifierParameter, List[int]]:
    """Trusted setup on ``device`` (the card unless the caller names another);
    ``rng`` provides ``sample_fr()``. Returns (pp, vp, t), the trapdoor t
    included as the reference does."""
    device = kernels.require_device(device)
    if nv <= 0:
        raise invalid_arg("nv must be positive")
    g = hc.G1.mul(hf.G1_GEN, rng.sample_fr())
    h = hc.G2.mul(hf.G2_GEN, rng.sample_fr())
    t = [rng.sample_fr() for _ in range(nv)]

    with span("keygen eq tables"):
        suffix = mle.eq_suffix_tables(t, device)
        all_scalars = torch.cat([fo.from_mont(FR, suffix[i]) for i in range(nv)], dim=1)

    # window width of the fixed-base tables: any width gives the same points
    c = 4 if nv < 10 else 8
    sizes = [1 << (nv - i) for i in range(nv)]
    with span("keygen fixed-base exps"):
        g_table = cv.normalize(msm_mod.fixed_base_table_device(g, hc.G1, cv.g1_encode, c, device))
        h_table = cv.normalize(msm_mod.fixed_base_table_device(h, hc.G2, cv.g2_encode, c, device))
        powers_of_g = _split_levels(cv.normalize(msm_mod.fixed_base_msm(g_table, all_scalars, c)), sizes)
        powers_of_h = _split_levels(cv.normalize(msm_mod.fixed_base_msm(h_table, all_scalars, c)), sizes)

    with span("keygen vp masks"):
        g_mask = [hc.G1.mul(g, ti) for ti in t]

    with span("keygen combined opening bases"):
        combs = PointBatch.cat([_combine_pairs_g2(pb) for pb in powers_of_h])
        powers_of_h_comb = _split_levels(cv.normalize(combs), [s // 2 for s in sizes])

    pp = PublicParameter(nv=nv, powers_of_g=powers_of_g, powers_of_h=powers_of_h, g=g, h=h,
                         powers_of_h_comb=powers_of_h_comb)
    vp = VerifierParameter(nv=nv, g=g, h=h, g_mask_random=g_mask)
    return pp, vp, t


def commit(pp: PublicParameter, poly: torch.Tensor) -> Commitment:
    """poly: (8, 2^nv) Montgomery Fr table. One G1 MSM."""
    nv = int(poly.shape[1]).bit_length() - 1
    if 1 << nv != poly.shape[1]:
        raise invalid_arg("polynomial table must be power-of-two sized")
    if nv != pp.nv:
        raise invalid_arg("polynomial nv mismatch with public parameter")
    scalars = fo.from_mont(FR, poly)
    with span("commit MSM"):
        res = msm_mod.msm(pp.powers_of_g[0], scalars)
    return Commitment(nv=nv, g_product=cv.g1_decode(res)[0])


def _quotients_and_eval_plain(poly: torch.Tensor, point_mont: torch.Tensor):
    """All quotient tables q_i[b] = r_i[2b+1] - r_i[2b] (canonical,
    concatenated largest first) and the evaluation (canonical (8, 1)); the
    remainder folds as r_{i+1} = even + p_i q_i. On the plain Fr versions."""
    one = fo.encode_ints(FR, [1], poly.device)
    r = poly
    outs = []
    for i in range(point_mont.shape[1]):
        even, odd = r[:, 0::2], r[:, 1::2]
        q = fo.sub_plain(FR, odd, even)
        outs.append(fo.mont_mul_plain(FR, *torch.broadcast_tensors(q, one)))
        r = fo.add_plain(FR, even, fo.mont_mul_plain(FR, *torch.broadcast_tensors(q, point_mont[:, i : i + 1])))
    return torch.cat(outs, dim=1), fo.mont_mul_plain(FR, r, one)


QUOT_TAIL_PAIRS = 1024  # csrc/fr_tables.cuh kTailPairs: the tail's first level, at most


def _quotients_and_eval(poly: torch.Tensor, point_mont: torch.Tensor):
    """``_quotients_and_eval_plain``'s tables and evaluation
    (``spartan_tpu/commitment/scheme.py:175``): on the card one launch of
    K1's ``quot_level`` a level down to the first level of at most
    QUOT_TAIL_PAIRS pairs, then one ``quot_tail`` for the rest and the
    evaluation (``csrc/fr_tables.cuh``). A CPU table takes the plain loop."""
    if poly.device.type == "cpu":
        return _quotients_and_eval_plain(poly, point_mont)
    nv = point_mont.shape[1]
    dev = poly.device
    pt = point_mont.contiguous()
    qcat = torch.empty((FR.nlimb, (1 << nv) - 1), dtype=torch.int32, device=dev)
    ev = torch.empty((FR.nlimb, 1), dtype=torch.int32, device=dev)
    level0 = max(0, nv - QUOT_TAIL_PAIRS.bit_length())
    r = poly.contiguous()
    if level0:  # two remainders in turn: 2^(nv-1) lanes for even levels, 2^(nv-2) for odd
        scratch = torch.empty(FR.nlimb * 3 << (nv - 2), dtype=torch.int32, device=dev)
        for level in range(level0):
            pairs = 1 << (nv - 1 - level)
            base = 0 if level % 2 == 0 else FR.nlimb << (nv - 1)
            out = scratch[base : base + FR.nlimb * pairs].view(FR.nlimb, pairs)
            kernels.call("quot_level", [r, pt, qcat, out], [nv, level], (pairs,))
            r = out
    kernels.call("quot_tail", [r, pt, qcat, ev], [nv, level0], (r.shape[1] // 2,))
    return qcat, ev


def banded_g2_msms(bases_list, scalars_list, sizes) -> PointBatch:
    """The per-level opening MSMs as two fused ``msm_many`` calls: levels of
    512 points or more with 8-bit windows, the small tail levels with 4-bit
    windows (fewer buckets to reduce per level). Returns one G2 point per
    level, in level order."""
    results = [None] * len(sizes)
    for c, levels in ((8, [i for i, s in enumerate(sizes) if s >= 512]),
                      (4, [i for i, s in enumerate(sizes) if s < 512])):
        if not levels:
            continue
        bases = PointBatch.cat([bases_list[i] for i in levels])
        scalars = torch.cat([scalars_list[i] for i in levels], dim=1)
        res = msm_mod.msm_many(bases, [sizes[i] for i in levels], scalars, c)
        for j, i in enumerate(levels):
            results[i] = res.take(slice(j, j + 1))
    return PointBatch.cat(results)


def open_poly(pp: PublicParameter, poly: torch.Tensor, point: List[int]):
    """Evaluate poly at point and prove it. Returns (eval int, OpenProof,
    per-level canonical quotient tables)."""
    nv = pp.nv
    if len(point) != nv:
        raise invalid_arg("point dimension mismatch")
    point_mont = fo.encode_mont(FR, point, poly.device)
    with span("open quotients + eval"):
        qcat, ev = _quotients_and_eval(poly, point_mont)

    q_tables, sizes = [], []
    off = 0
    for i in range(nv):
        m = 1 << (nv - 1 - i)
        q_tables.append(qcat[:, off : off + m])
        sizes.append(m)
        off += m
    with span("open G2 MSMs"):
        res = banded_g2_msms(pp.powers_of_h_comb, q_tables, sizes)
        proofs = cv.g2_decode(res)
    return fo.decode_ints(FR, ev)[0], OpenProof(h=pp.h, proofs=proofs), q_tables


def verify(vp: VerifierParameter, commitment: Commitment, point: List[int], evaluation: int,
           proof: OpenProof) -> bool:
    """Host pairing check e(com g^-eval, h) == prod_i e(g^{t_i - point_i}, proof_i)."""
    with span("PC verify pairings"):
        left_pt = hc.g1_lincomb([commitment.g_product, vp.g], [1, hf.R - evaluation % hf.R])
        left = hp.pairing(left_pt, vp.h)
        pairs = []
        for i in range(vp.nv):
            lhs = hc.g1_lincomb([vp.g_mask_random[i], vp.g], [1, hf.R - point[i] % hf.R])
            pairs.append((lhs, proof.proofs[i]))
        right = hp.product_of_pairings(pairs)
    return left == right
