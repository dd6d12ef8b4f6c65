"""Spartan prover: six rounds and two sumchecks.

Counterpart of ``spartan_tpu/protocol/prover.py`` (:173-371), the same
typed state machine and messages. Sumcheck 1 evaluates the inner quadratic
sum_b eq(tor_{i+1..}, b) (Az Bz - Cz)(t, b) at t = 0, 1, 2 on the device
and the host extends the exact cubic pre * l_i(t) * q(t) to the
log_n + 3 points of the wire format. These sumcheck rounds are the host
loop's; by default ``argument.prove`` runs both sumcheck phases and round
4 with the transcript on the device instead (``protocol/fused.py``). Device
work follows the device of ``pp`` and of the index, or a ``Route``: the
commit, the openings and the sumcheck rounds that ``parallel/sharded_prove.py``
splits over a mesh.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional

import torch

from spartan_tpu_torch.commitment import PublicParameter, commit, open_poly
from spartan_tpu_torch.commitment.data_structures import Commitment, OpenProof
from spartan_tpu_torch.host import field as hf
from spartan_tpu_torch.ops import field as fo
from spartan_tpu_torch.ops import mle, sparse
from spartan_tpu_torch.ops import sumcheck as sck
from spartan_tpu_torch.ops.field import FR
from spartan_tpu_torch.protocol import sumcheck as sc
from spartan_tpu_torch.protocol.indexer import IndexPK
from spartan_tpu_torch.timers import span
from spartan_tpu_torch.utils import serialize as ser
from spartan_tpu_torch.utils.errors import invalid_arg


def ell(tor_j: int, t: int) -> int:
    """The eq factor of one variable: l_j(t) = tor_j t + (1 - tor_j)(1 - t)."""
    return (tor_j * t + (1 - tor_j) * (1 - t)) % hf.R


def _commit(pp: PublicParameter, z: torch.Tensor) -> Commitment:
    return commit(pp, z)


def _open(pp: PublicParameter, z: torch.Tensor, point: List[int]):
    z_at, proof, _ = open_poly(pp, z, point)
    return z_at, proof


@dataclass(frozen=True)
class Route:
    """Where the rounds' device work runs. The default is the device of
    ``pp`` and of the index; ``parallel/sharded_prove.py:route`` gives a
    mesh's. ``split`` takes a sumcheck table to the form the round
    functions take and return (a shard list there), ``join`` takes it back
    to one table for round 4. ``label`` ends the host loop's span names."""

    commit: Callable = _commit  # (pp, z) -> Commitment
    open: Callable = _open  # (pp, z, point) -> (z(point), OpenProof)
    split: Callable = lambda t: t  # noqa: E731
    join: Callable = lambda t: t  # noqa: E731
    sc1_round: Callable = sck.sc1_round
    prod2_round: Callable = sck.prod2_round
    label: str = ""


ONE_DEVICE = Route()


# -- messages (wire format; their bytes feed the transcript) ----------------


@dataclass(frozen=True)
class ProverFirstMessage:
    commitment: Commitment

    def serialize(self) -> bytes:
        return self.commitment.serialize()


@dataclass(frozen=True)
class ProverSecondMessage:
    z_rv_0: int
    proof_for_z_rv_0: OpenProof

    def serialize(self) -> bytes:
        return ser.ser_fr(self.z_rv_0) + self.proof_for_z_rv_0.serialize()


@dataclass(frozen=True)
class ProverThirdMessage:
    ml_index_info: sc.IndexInfo

    def serialize(self) -> bytes:
        return self.ml_index_info.serialize()


@dataclass(frozen=True)
class ProverFourthMessage:
    va: int
    vb: int
    vc: int

    def serialize(self) -> bytes:
        return ser.ser_fr(self.va) + ser.ser_fr(self.vb) + ser.ser_fr(self.vc)


@dataclass(frozen=True)
class ProverFifthMessage:
    index_info: sc.IndexInfo

    def serialize(self) -> bytes:
        return self.index_info.serialize()


@dataclass(frozen=True)
class ProverSixthMessage:
    z_ry: int
    proof_for_z_ry: OpenProof

    def serialize(self) -> bytes:
        return ser.ser_fr(self.z_ry) + self.proof_for_z_ry.serialize()


# -- states -------------------------------------------------------------------


@dataclass
class ProverFirstState:
    v: List[int]
    w: List[int]
    pk: IndexPK


@dataclass
class ProverSecondState:
    v: List[int]
    w: List[int]
    pk: IndexPK
    z: torch.Tensor  # (8, n) Montgomery


@dataclass
class ProverThirdState:
    pk: IndexPK
    z: torch.Tensor


@dataclass
class ProverFirstSumcheckState:
    pk: IndexPK
    z: torch.Tensor
    az: torch.Tensor  # folded sum_y A z tables (in the route's split form)
    bz: torch.Tensor
    cz: torch.Tensor
    suffix: list  # eq suffix tables of tor
    tor: List[int]
    pre: int  # prod_{j < round} l_j(r_j)
    round: int
    randomness: List[int]


@dataclass
class ProverFifthState:
    pk: IndexPK
    z: torch.Tensor
    r_x: List[int]


@dataclass
class ProverSecondSumcheckState:
    z: torch.Tensor  # the original z table, opened at r_y in round 6
    w_cur: torch.Tensor  # folded (r_a A + r_b B + r_c C)(r_x, .), split as az
    z_cur: torch.Tensor  # folded copy of z
    round: int
    randomness: List[int]


# -- rounds -------------------------------------------------------------------


def prover_init(pk: IndexPK, v: List[int], w: List[int]) -> ProverFirstState:
    if len(v) == 0 or len(v) & (len(v) - 1):
        raise invalid_arg("public input should be power of two")
    if len(v) + len(w) != pk.matrix_a.num_constraints:
        raise invalid_arg("|v| + |w| != number of variables")
    return ProverFirstState(v=list(v), w=list(w), pk=pk)


def prover_first_round(state: ProverFirstState, pp: PublicParameter, route: Route = ONE_DEVICE):
    """Commit to z = v || w."""
    z = fo.encode_witness(FR, state.v + state.w, pp.device)
    with span("Prove 1: commit z"):
        com = route.commit(pp, z)
    return (
        ProverSecondState(v=state.v, w=state.w, pk=state.pk, z=z),
        ProverFirstMessage(commitment=com),
    )


def prover_second_round(state: ProverSecondState, r_v: List[int], pp: PublicParameter,
                        route: Route = ONE_DEVICE):
    """Open z at (r_v || 0...0)."""
    point = list(r_v) + [0] * (state.pk.log_n - len(r_v))
    with span("Prove 2: open z(r_v,0..)"):
        z_rv_0, proof = route.open(pp, state.z, point)
    return (
        ProverThirdState(pk=state.pk, z=state.z),
        ProverSecondMessage(z_rv_0=z_rv_0, proof_for_z_rv_0=proof),
    )


def prover_third_round(state: ProverThirdState, tor: List[int], route: Route = ONE_DEVICE):
    """Sparse A z, B z, C z and the eq suffix tables of tor."""
    pk = state.pk
    n = state.z.shape[1]
    with span("Prove 3: sparse mat-vec + eq"):
        z = state.z[None]  # the sparse products' batch axis, B = 1
        az, bz, cz = (sparse.sum_over_y(m.coo, z, n)[0] for m in (pk.matrix_a, pk.matrix_b, pk.matrix_c))
        suffix = mle.eq_suffix_tables(tor, state.z.device)
    info = sc.IndexInfo(max_multiplicands=pk.log_n + 2, num_variables=pk.log_n)
    next_state = ProverFirstSumcheckState(
        pk=pk, z=state.z, az=route.split(az), bz=route.split(bz), cz=route.split(cz), suffix=suffix,
        tor=list(tor), pre=1, round=0, randomness=[],
    )
    return next_state, ProverThirdMessage(ml_index_info=info)


def _challenge(v_msg: Optional[sc.VerifierMsg], round_: int, device):
    if round_ > 0:
        if v_msg is None:
            raise invalid_arg("expected verifier randomness")
        return v_msg.randomness, fo.encode_mont(FR, [v_msg.randomness], device)
    if v_msg is not None:
        raise invalid_arg("first round takes no randomness")
    return None, None


def prove_first_sumcheck_round(state: ProverFirstSumcheckState, v_msg: Optional[sc.VerifierMsg],
                               route: Route = ONE_DEVICE):
    """One sumcheck-1 round: fold by the challenge, evaluate the inner
    quadratic q at 0, 1, 2, extend pre * l_i(t) * q(t) to 0..log_n+2."""
    l = state.pk.log_n
    i = state.round
    if i >= l:
        raise invalid_arg("sumcheck 1 already finished")
    r, r_dev = _challenge(v_msg, i, state.z.device)
    if r is not None:
        state.pre = state.pre * ell(state.tor[i - 1], r) % hf.R
        state.randomness.append(r)
    evals3, state.az, state.bz, state.cz = route.sc1_round(
        state.az, state.bz, state.cz, state.suffix[i + 1], r is not None, r_dev
    )
    q0, q1, q2 = fo.decode_mont(FR, evals3)
    inv2 = hf.fr_inv(2)

    def q_at(t: int) -> int:
        return (
            q0 * ((t - 1) * (t - 2) % hf.R) % hf.R * inv2
            - q1 * (t * (t - 2) % hf.R)
            + q2 * (t * (t - 1) % hf.R) % hf.R * inv2
        ) % hf.R

    tor_i = state.tor[i]
    evals = [state.pre * ell(tor_i, t) % hf.R * q_at(t) % hf.R for t in range(l + 3)]
    state.round += 1
    return state, sc.ProverMsg(evaluations=evals)


def prove_fourth_round(state: ProverFirstSumcheckState, last_random_point: int, route: Route = ONE_DEVICE):
    """Final fold; send va, vb, vc = (A z)(r_x), (B z)(r_x), (C z)(r_x)."""
    r_dev = fo.encode_mont(FR, [last_random_point], state.z.device)
    abz = torch.cat([route.join(state.az), route.join(state.bz), route.join(state.cz)], dim=1)
    va, vb, vc = fo.decode_mont(FR, mle.fold(abz, r_dev))
    r_x = state.randomness + [last_random_point]
    return (
        ProverFifthState(pk=state.pk, z=state.z, r_x=r_x),
        ProverFourthMessage(va=va, vb=vb, vc=vc),
    )


def prove_fifth_round(state: ProverFifthState, r_a: int, r_b: int, r_c: int, route: Route = ONE_DEVICE):
    """Sumcheck 2 over (r_a A + r_b B + r_c C)(r_x, .) * z, one product of
    two factors (the reference's three products summed)."""
    pk = state.pk
    dev = state.z.device
    n = state.z.shape[1]
    with span("Prove 5: eval_on_x + combine"):
        eqx = mle.eq_table(fo.encode_mont(FR, state.r_x, dev)[None])  # (1, 8, n): B = 1
        rabc = fo.encode_mont(FR, [r_a, r_b, r_c], dev)
        w = None
        for j, m in enumerate((pk.matrix_a, pk.matrix_b, pk.matrix_c)):
            term = mle.scale(sparse.eval_on_x_table(m.coo, eqx, n)[0], rabc[:, j])
            w = term if w is None else fo.add(FR, w, term)
    info = sc.IndexInfo(max_multiplicands=2, num_variables=pk.log_n)
    return (
        ProverSecondSumcheckState(z=state.z, w_cur=route.split(w), z_cur=route.split(state.z), round=0,
                                  randomness=[]),
        ProverFifthMessage(index_info=info),
    )


def prove_second_sumcheck_round(state: ProverSecondSumcheckState, v_msg: Optional[sc.VerifierMsg],
                                route: Route = ONE_DEVICE):
    """One degree-2 sumcheck round over W * z."""
    r, r_dev = _challenge(v_msg, state.round, state.z.device)
    if r is not None:
        state.randomness.append(r)
    evals3, state.w_cur, state.z_cur = route.prod2_round(state.w_cur, state.z_cur, r is not None, r_dev)
    state.round += 1
    return state, sc.ProverMsg(evaluations=fo.decode_mont(FR, evals3))


def prove_sixth_round(state: ProverSecondSumcheckState, last_random_point: int,
                      pp: PublicParameter, route: Route = ONE_DEVICE) -> ProverSixthMessage:
    """Open z at r_y."""
    r_y = state.randomness + [last_random_point]
    with span("Prove 6: open z(r_y)"):
        z_ry, proof = route.open(pp, state.z, r_y)
    return ProverSixthMessage(z_ry=z_ry, proof_for_z_ry=proof)
