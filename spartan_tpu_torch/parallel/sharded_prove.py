"""Mesh-sharded prover: the route that ``MLArgumentForR1CS.prove(...,
mesh=...)`` runs its host loop on.

Counterpart of ``spartan_tpu/parallel/sharded_prove.py``:

- the commit and the opening levels of at least 128 points a shard run
  the point-range MSM (``sharded.msm``); the smaller levels run as the
  single-device opening runs them (``scheme.banded_g2_msms``);
- both sumchecks run their rounds over tables sharded by high-order bits
  (``sharded.sc1_round``, ``sharded.prod2_round``). Once a shard would hold
  less than one pair, the tables are gathered on the first device in shard
  order and the rest runs unsharded;
- the transcript runs on the host (``argument.prove``'s host loop, the
  same code as the single-device route): challenges are host ints and
  every cross-shard sum is exact mod r, so the proof is byte-identical to
  the single-device prove at any device count.

Rounds 3 and 5 (the sparse products and the eq tables) run on the first
device with the single-device prover's functions, as in the JAX version.
``pk`` and ``pp`` live on the mesh's first device. The verifier is the
single-device one.
"""

from __future__ import annotations

from functools import partial
from typing import List

from spartan_tpu_torch.commitment import PublicParameter
from spartan_tpu_torch.commitment import scheme
from spartan_tpu_torch.commitment.data_structures import Commitment, OpenProof
from spartan_tpu_torch.ops import curve as cv
from spartan_tpu_torch.ops import field as fo
from spartan_tpu_torch.ops import sumcheck as sck
from spartan_tpu_torch.ops.curve import PointBatch
from spartan_tpu_torch.ops.field import FR
from spartan_tpu_torch.parallel import sharded
from spartan_tpu_torch.protocol import prover as pr
from spartan_tpu_torch.timers import span
from spartan_tpu_torch.utils.errors import invalid_arg

SHARDED_LEVEL = 128  # an opening level runs sharded from this many points a shard


def sharded_commit(pp: PublicParameter, poly, mesh: sharded.Mesh) -> Commitment:
    """The commit's G1 MSM split by point range (``sharded_prove.py:54``)."""
    nv = int(poly.shape[1]).bit_length() - 1
    if nv != pp.nv:
        raise invalid_arg("polynomial nv mismatch with public parameter")
    res = sharded.msm(mesh, sharded.shard_points(mesh, pp.powers_of_g[0]),
                      sharded.shard_table(mesh, fo.from_mont(FR, poly)))
    return Commitment(nv=nv, g_product=cv.g1_decode(res)[0])


def sharded_open(pp: PublicParameter, poly, point: List[int], mesh: sharded.Mesh):
    """The PST opening with the large levels' G2 MSMs split by point range
    (``sharded_prove.py:68``): levels of at least SHARDED_LEVEL * D points
    run ``sharded.msm``, the rest ``scheme.banded_g2_msms``. The quotients
    come from ``scheme._quotients_and_eval`` on the first device. Returns
    (evaluation, OpenProof), as ``prover.Route.open``."""
    nv = pp.nv
    if len(point) != nv:
        raise invalid_arg("point dimension mismatch")
    if pp.powers_of_h_comb is None:
        raise invalid_arg("sharded open requires combined opening bases")
    with span("open quotients + eval (sharded)"):
        qcat, ev = scheme._quotients_and_eval(poly, fo.encode_mont(FR, point, poly.device))
    results = [None] * nv
    small = []  # (level, scalars, bases, size)
    off = 0
    with span("open G2 MSMs (sharded)"):
        for i in range(nv):
            m = 1 << (nv - 1 - i)
            q = qcat[:, off : off + m]
            off += m
            bases = pp.powers_of_h_comb[i]
            if m >= SHARDED_LEVEL * len(mesh):
                results[i] = sharded.msm(mesh, sharded.shard_points(mesh, bases), sharded.shard_table(mesh, q))
            else:
                small.append((i, q, bases, m))
        if small:
            res = scheme.banded_g2_msms([b for _i, _q, b, _m in small], [q for _i, q, _b, _m in small],
                                        [m for _i, _q, _b, m in small])
            for j, (i, _q, _b, _m) in enumerate(small):
                results[i] = res.take(slice(j, j + 1))
        proofs = cv.g2_decode(PointBatch.cat(results))
    return fo.decode_ints(FR, ev)[0], OpenProof(h=pp.h, proofs=proofs)


def _unsharded(mesh: sharded.Mesh, tabs, do_fold: bool):
    """The round's tables, gathered on the first device in shard order once
    a shard would hold no pair after the round's fold
    (``sharded_prove.py:174-178``, ``:251-254``)."""
    if isinstance(tabs[0], list) and (tabs[0][0].shape[-1] >> do_fold) < 2:
        return [sharded.gather(mesh, t) for t in tabs]
    return tabs


def _sc1_round(mesh: sharded.Mesh, az, bz, cz, s_table, do_fold: bool, r=None):
    tabs = _unsharded(mesh, (az, bz, cz), do_fold)
    if isinstance(tabs[0], list):
        return sharded.sc1_round(mesh, *tabs, s_table, do_fold, r)
    return sck.sc1_round(*tabs, s_table, do_fold, r)


def _prod2_round(mesh: sharded.Mesh, w, z, do_fold: bool, r=None):
    tabs = _unsharded(mesh, (w, z), do_fold)
    if isinstance(tabs[0], list):
        return sharded.prod2_round(mesh, *tabs, do_fold, r)
    return sck.prod2_round(*tabs, do_fold, r)


def _join(mesh: sharded.Mesh, tab):
    return sharded.gather(mesh, tab) if isinstance(tab, list) else tab


def route(mesh: sharded.Mesh) -> pr.Route:
    """The host loop's route over ``mesh`` (``sharded_prove.py:117-288``),
    its spans named "Prove 1 (sharded)" .. "Prove 6 (sharded)"."""
    return pr.Route(
        commit=partial(sharded_commit, mesh=mesh),
        open=partial(sharded_open, mesh=mesh),
        split=partial(sharded.shard_table, mesh),
        join=partial(_join, mesh),
        sc1_round=partial(_sc1_round, mesh),
        prod2_round=partial(_prod2_round, mesh),
        label=" (sharded)",
    )
