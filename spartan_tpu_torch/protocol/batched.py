"""Batched proving: B instances of one circuit with shared launches.

Counterpart of ``spartan_tpu/protocol/batched.py``. ``prove_many`` stacks
the instances on a batch axis, (B, 8, n) tables with each instance a
contiguous (8, n) table, and launches once for the batch wherever the JAX
package dispatches once for it:

- the witnesses are encoded in one host pass, one upload and one
  ``fr_mul`` launch (``fo.encode_witness_many``);
- the commits are ``msm_many`` calls of many problems over the shared
  bases ``pp.powers_of_g[0]``, read by index (at most COMMIT_SCALARS
  scalars a call, for memory), decoded with one ``g1_normalize`` launch
  and one fetch (``commit_many``);
- each opening runs its own quotient ladder; the level MSMs of all
  instances go into the banded ``msm_many`` calls of a single opening,
  grouped under a lane budget, and all B x nv points decode with one
  ``g2_normalize`` launch and one fetch (``open_many``);
- the sparse products are one product launch and one ``index_add_`` for
  the batch (``ops/sparse.py``), the eq tables one ``eq_tables`` launch an
  instance (``ops/mle.py``);
- each sumcheck phase, round 4 included, is one launch a round and one
  tail for the whole batch (``protocol/fused.py``'s ``sc1_round``,
  ``prod2_round``, ``sc1_tail`` and ``sc2_tail``): the same 18 launches a
  2^16 prove as one instance takes, whatever B is.

Each instance keeps its own transcript (it absorbs its own public input),
so each proof is byte-identical to what ``MLArgumentForR1CS.prove`` gives
for it. The JAX package's two-stage segment sum and its ``TAIL_W`` padding
are TPU workarounds and have no counterpart. ``prove_many`` runs on the
device of ``pp``: on the card it launches the kernels or raises.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from spartan_tpu_torch.commitment import PublicParameter, scheme
from spartan_tpu_torch.commitment.data_structures import Commitment, OpenProof
from spartan_tpu_torch.ops import curve as cv
from spartan_tpu_torch.ops import field as fo
from spartan_tpu_torch.ops import mle, sparse
from spartan_tpu_torch.ops import msm as msm_mod
from spartan_tpu_torch.ops.curve import PointBatch
from spartan_tpu_torch.ops.field import FR
from spartan_tpu_torch.protocol import fused
from spartan_tpu_torch.protocol import prover as pr
from spartan_tpu_torch.protocol import sumcheck as sc
from spartan_tpu_torch.protocol.indexer import IndexPK
from spartan_tpu_torch.protocol.proof import Proof
from spartan_tpu_torch.timers import span
from spartan_tpu_torch.utils import serialize as ser
from spartan_tpu_torch.utils.errors import invalid_arg
from spartan_tpu_torch.utils.transcript import Blake2sRng

__all__ = ["commit_many", "open_many", "prove_many", "prove_batch", "verify_batch"]

# scalars of one commit msm_many at most: with every 8-bit digit non-zero
# (a full witness), the gathered G1 bases, _neg_y's copies of their y and the
# first bucket level take about 14 KiB a scalar (14 GiB at the cap); B = 64
# instances of 2^16 are four calls
COMMIT_SCALARS = 1 << 20
# lanes (windows x points) of one opening msm_many at most: an opening of
# 2^16's 8-bit band is 32 x 65,024 = 2.08 M lanes, whose gathered G2 bases
# alone take 0.6 GB and the bucket sums' copies about three times that; the
# cap holds 8 such bands (about 19 GB), the 4-bit bands of 64 openings in one
OPEN_LANES = 1 << 24


def _stack(polys) -> torch.Tensor:
    """Polynomial tables, a sequence of (8, n) or one (B, 8, n) -> (B, 8, n)."""
    return polys if isinstance(polys, torch.Tensor) else torch.stack(list(polys))


def commit_many(pp: PublicParameter, polys) -> List[Commitment]:
    """Commit to each of B tables (8, 2^nv) Montgomery: G1 ``msm_many``
    calls of up to COMMIT_SCALARS // 2^nv problems over the shared bases,
    decoded with one normalize launch and one fetch
    (``spartan_tpu/protocol/batched.py:443``)."""
    tabs = _stack(polys)
    bsz, _k, n = tabs.shape
    if n != 1 << pp.nv:
        raise invalid_arg("polynomial nv mismatch with public parameter")
    step = max(1, COMMIT_SCALARS // n)
    results = []
    for b0 in range(0, bsz, step):
        part = tabs[b0 : b0 + step]
        scalars = fo.from_mont(FR, part.transpose(0, 1).reshape(FR.nlimb, -1))
        results.append(msm_mod.msm_many(pp.powers_of_g[0], [n] * part.shape[0], scalars))
    points = cv.g1_decode(PointBatch.cat(results))
    return [Commitment(nv=pp.nv, g_product=pt) for pt in points]


def open_many(pp: PublicParameter, polys, points: Sequence[Sequence[int]]) -> List[Tuple[int, OpenProof]]:
    """Open each table at its point (``spartan_tpu/protocol/batched.py:466``).

    Each instance runs its quotient ladder (``scheme._quotients_and_eval``);
    the level MSMs of all instances go into the banded ``msm_many`` calls of
    ``scheme.banded_g2_msms`` (8-bit windows for levels of 512 points or
    more, 4-bit below), instances grouped so that a call holds at most
    OPEN_LANES lanes. The evaluations come back in one fetch and the B x nv
    proof points in one ``g2_normalize`` launch and one fetch. Returns
    (evaluation, OpenProof) for each."""
    if pp.powers_of_h_comb is None:
        raise invalid_arg("batched open requires combined opening bases")
    tabs = _stack(polys)
    nv, bsz = pp.nv, tabs.shape[0]
    if len(points) != bsz:
        raise invalid_arg("one point per polynomial expected")
    qcats, evs = [], []
    for poly, point in zip(tabs, points):
        if len(point) != nv:
            raise invalid_arg("point dimension mismatch")
        qcat, ev = scheme._quotients_and_eval(poly, fo.encode_mont(FR, point, tabs.device))
        qcats.append(qcat)
        evs.append(ev)

    sizes = [1 << (nv - 1 - i) for i in range(nv)]  # level i's quotient table
    offs = [sum(sizes[:i]) for i in range(nv)]
    results = [[None] * nv for _ in range(bsz)]

    def flush(group, c):
        if not group:
            return
        bases = PointBatch.cat([pp.powers_of_h_comb[i] for _j, i in group])
        scalars = torch.cat([qcats[j][:, offs[i] : offs[i] + sizes[i]] for j, i in group], dim=1)
        res = msm_mod.msm_many(bases, [sizes[i] for _j, i in group], scalars, c)
        for slot, (j, i) in enumerate(group):
            results[j][i] = res.take(slice(slot, slot + 1))

    for c, levels in ((8, [i for i in range(nv) if sizes[i] >= 512]), (4, [i for i in range(nv) if sizes[i] < 512])):
        group, lanes = [], 0
        for j in range(bsz):
            for i in levels:
                add = (msm_mod.SCALAR_BITS // c) * sizes[i]
                if group and lanes + add > OPEN_LANES:
                    flush(group, c)
                    group, lanes = [], 0
                group.append((j, i))
                lanes += add
        flush(group, c)

    evals = fo.decode_ints(FR, torch.cat(evs, dim=1))  # fetch 1
    proofs = cv.g2_decode(PointBatch.cat([results[j][i] for j in range(bsz) for i in range(nv)]))  # fetch 2
    return [(evals[j], OpenProof(h=pp.h, proofs=proofs[j * nv : (j + 1) * nv])) for j in range(bsz)]


def _points_mont(points: Sequence[Sequence[int]], device) -> torch.Tensor:
    """B points of nv ints -> (B, 8, nv) Montgomery."""
    bsz, nv = len(points), len(points[0])
    flat = fo.encode_mont(FR, [x for p in points for x in p], device)  # (8, B nv)
    return flat.view(FR.nlimb, bsz, nv).transpose(0, 1).contiguous()


def prove_many(pk: IndexPK, instances: Sequence[Tuple[List[int], List[int]]], pp: PublicParameter) -> List[Proof]:
    """Prove B instances (v, w) of the circuit ``pk`` with shared launches
    (``spartan_tpu/protocol/batched.py:560``). Each proof equals, byte for
    byte, ``MLArgumentForR1CS.prove(pk, v, w, pp)``. The instances share the
    circuit and the public input's length."""
    if not instances:
        return []
    if pk.matrix_a.coo[2].device != pp.device:
        raise invalid_arg(f"index on {pk.matrix_a.coo[2].device}, parameters on {pp.device}")
    bsz, log_n = len(instances), pk.log_n
    n, dev = 1 << log_n, pp.device
    if log_n < 2:
        raise invalid_arg("batched proving requires log_n >= 2")
    log_v = len(instances[0][0]).bit_length() - 1
    if log_v < 0 or any(len(v) != 1 << log_v for v, _ in instances):
        raise invalid_arg("all instances must share the public-input length")
    if any(len(v) + len(w) != n for v, w in instances):
        raise invalid_arg("|v| + |w| != number of variables")

    # each instance its own transcript: the matrices' absorptions are common
    # to all, kept by the index; then each absorbs its own public input
    # (reference src/lib.rs:61-65)
    fss = []
    for v, _w in instances:
        fs = Blake2sRng.setup()
        fs.set_state(pk.fs_state)
        fs.feed(ser.ser_fr_vec(v))
        fss.append(fs)

    with span("Batch Prove 0: encode z"):  # before the commits' span, as in the JAX package
        z = fo.encode_witness_many(FR, [list(v) + list(w) for v, w in instances], dev)  # (B, 8, n)
    with span("Batch Prove 1: commits"):
        pm1s = [pr.ProverFirstMessage(commitment=c) for c in commit_many(pp, z)]
    r_vs = []
    for fs, pm1 in zip(fss, pm1s):
        fs.feed(pm1.serialize())
        r_vs.append(fs.sample_fr_vec(log_v))

    with span("Batch Prove 2: opens z(r_v,0..)"):
        opens = open_many(pp, z, [list(rv) + [0] * (log_n - log_v) for rv in r_vs])
    pm2s, tors = [], []
    for fs, (ev, prf) in zip(fss, opens):
        pm2 = pr.ProverSecondMessage(z_rv_0=ev, proof_for_z_rv_0=prf)
        pm2s.append(pm2)
        fs.feed(pm2.serialize())
        tors.append(fs.sample_fr_vec(log_n))

    mats = (pk.matrix_a, pk.matrix_b, pk.matrix_c)
    with span("Batch Prove 3: sparse mat-vec"):
        az, bz, cz = (sparse.sum_over_y(m.coo, z, n) for m in mats)
    pm3 = pr.ProverThirdMessage(ml_index_info=sc.IndexInfo(max_multiplicands=log_n + 2, num_variables=log_n))
    for fs in fss:
        fs.feed(pm3.serialize())

    with span("Batch Prove SC1 (fused)"):
        suffix = mle.eq_suffix_tables_mont(_points_mont(tors, dev))
        res1 = fused.sc1_phase(az, bz, cz, suffix, tors, [fs.get_state() for fs in fss])
    for fs, r in zip(fss, res1):
        fs.set_state(r.state)

    with span("Batch Prove 5: eval_on_x + combine"):
        eqx = mle.eq_table(_points_mont([r.rs for r in res1], dev))
        rabc = _points_mont([r.rabc for r in res1], dev).transpose(0, 1)  # (8, B, 3)
        w = None
        for j, m in enumerate(mats):
            term = fo.mont_mul(FR, sparse.eval_on_x_table(m.coo, eqx, n).transpose(0, 1), rabc[:, :, j : j + 1])
            w = term if w is None else fo.add(FR, w, term)
        w = w.transpose(0, 1).contiguous()  # (B, 8, n)
    pm5 = pr.ProverFifthMessage(index_info=sc.IndexInfo(max_multiplicands=2, num_variables=log_n))
    for fs in fss:
        fs.feed(pm5.serialize())

    with span("Batch Prove SC2 (fused)"):
        res2 = fused.sc2_phase_b(w, z, [fs.get_state() for fs in fss])  # sc2_phase, by the name tests patch
    for fs, r in zip(fss, res2):
        fs.set_state(r.state)

    with span("Batch Prove 6: opens z(r_y)"):
        opens6 = open_many(pp, z, [r.rs for r in res2])
    return [
        Proof(
            prover_first_message=pm1s[b],
            prover_second_message=pm2s[b],
            prover_third_message=pm3,
            first_sumcheck_messages=[sc.ProverMsg(evaluations=e) for e in res1[b].evals],
            prover_fourth_message=pr.ProverFourthMessage(*res1[b].vabc),
            prover_fifth_message=pm5,
            second_sumcheck_messages=[sc.ProverMsg(evaluations=e) for e in res2[b].evals],
            prover_sixth_message=pr.ProverSixthMessage(z_ry=opens6[b][0], proof_for_z_ry=opens6[b][1]),
        )
        for b in range(bsz)
    ]


def prove_batch(pk: IndexPK, instances: Sequence[Tuple[List[int], List[int]]], pp: PublicParameter) -> List[Proof]:
    """Prove the instances one at a time (``spartan_tpu/protocol/batched.py:706``)."""
    from spartan_tpu_torch.protocol.argument import MLArgumentForR1CS

    return [MLArgumentForR1CS.prove(pk, v, w, pp) for v, w in instances]


def verify_batch(vk, instances, proofs, vp) -> List[bool]:
    """Verify each proof against its instance's public input
    (``spartan_tpu/protocol/batched.py:715``)."""
    from spartan_tpu_torch.protocol.argument import MLArgumentForR1CS

    return [MLArgumentForR1CS.verify(vk, v, proof, vp) for (v, _w), proof in zip(instances, proofs)]
