"""Spartan verifier: the mirror state machine with deferred checks, on the
host.

Counterpart of ``spartan_tpu/protocol/verifier.py``. Every real check runs
in ``verify_sixth_round``: both polynomial-commitment openings (host
pairings), the public-input evaluation, both sumcheck subclaims, and the
matrix evaluations A, B, C(r_x, r_y) through the native O(nnz) walk
(``host/native.py:matrix_eval3_native``), or on the index's device
(``matrix_evals_device``) where the walk returns None (no native library).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import torch

from spartan_tpu_torch.commitment import VerifierParameter, verify as pc_verify
from spartan_tpu_torch.commitment.data_structures import Commitment, OpenProof
from spartan_tpu_torch.host import field as hf
from spartan_tpu_torch.host import native as _native
from spartan_tpu_torch.ops import field as fo
from spartan_tpu_torch.ops import mle, sparse
from spartan_tpu_torch.ops.field import FR
from spartan_tpu_torch.protocol import sumcheck as sc
from spartan_tpu_torch.protocol.indexer import IndexVK
from spartan_tpu_torch.protocol.prover import (
    ProverFifthMessage,
    ProverFirstMessage,
    ProverFourthMessage,
    ProverSecondMessage,
    ProverSixthMessage,
    ProverThirdMessage,
    ell,
)
from spartan_tpu_torch.timers import span
from spartan_tpu_torch.utils.errors import WrongWitness, invalid_arg


# -- verifier messages (sampled; the prover derives the same via FS) --------


@dataclass(frozen=True)
class VerifierFirstMessage:
    r_v: List[int]


@dataclass(frozen=True)
class VerifierSecondMessage:
    tor: List[int]


@dataclass(frozen=True)
class VerifierThirdMessage:
    last_random_point: int


@dataclass(frozen=True)
class VerifierFourthMessage:
    r_a: int
    r_b: int
    r_c: int


@dataclass(frozen=True)
class VerifierFifthMessage:
    last_random_point: int


# -- states -----------------------------------------------------------------


@dataclass
class VerifierFirstState:
    v: List[int]
    log_v: int
    vk: IndexVK


@dataclass
class VerifierSecondState:
    v: List[int]
    log_v: int
    vk: IndexVK
    r_v: List[int]
    commit: Commitment


@dataclass
class VerifierThirdState:
    vk: IndexVK
    commit: Commitment
    tor: List[int]
    v: List[int]
    r_v: List[int]
    z_rv_0: int
    z_rv_0_proof: OpenProof


@dataclass
class VerifierFirstSumcheckState:
    vk: IndexVK
    commit: Commitment
    tor: List[int]
    ml_verifier: sc.VerifierState
    v: List[int]
    r_v: List[int]
    z_rv_0: int
    z_rv_0_proof: OpenProof


@dataclass
class VerifierFourthState:
    vk: IndexVK
    commit: Commitment
    tor: List[int]
    first_verifier_state: sc.VerifierState
    v: List[int]
    r_v: List[int]
    z_rv_0: int
    z_rv_0_proof: OpenProof


@dataclass
class VerifierFifthState:
    vk: IndexVK
    commit: Commitment
    r_a: int
    r_b: int
    r_c: int
    va: int
    vb: int
    vc: int
    tor: List[int]
    first_verifier_state: sc.VerifierState
    v: List[int]
    r_v: List[int]
    z_rv_0: int
    z_rv_0_proof: OpenProof


@dataclass
class VerifierSecondSumcheckState(VerifierFifthState):
    second_verifier_state: sc.VerifierState = None


# -- rounds -----------------------------------------------------------------


def verifier_init(vk: IndexVK, v: List[int]) -> VerifierFirstState:
    if len(v) == 0 or len(v) & (len(v) - 1) or len(v) > vk.matrix_a.num_constraints:
        raise invalid_arg(
            "public input should be power of two and smaller than num constraints"
        )
    return VerifierFirstState(v=list(v), log_v=len(v).bit_length() - 1, vk=vk)


def sample_first_round(log_v: int, rng) -> VerifierFirstMessage:
    return VerifierFirstMessage(r_v=rng.sample_fr_vec(log_v))


def verify_first_round(state: VerifierFirstState, p_msg: ProverFirstMessage, rng):
    msg = sample_first_round(state.log_v, rng)
    next_state = VerifierSecondState(
        v=state.v, log_v=state.log_v, vk=state.vk, r_v=list(msg.r_v),
        commit=p_msg.commitment,
    )
    return next_state, msg


def sample_second_round(log_n: int, rng) -> VerifierSecondMessage:
    return VerifierSecondMessage(tor=rng.sample_fr_vec(log_n))


def verify_second_round(state: VerifierSecondState, p_msg: ProverSecondMessage, rng):
    # z_rv_0 consistency check deferred to round 6 (verifier.rs:188-194)
    msg = sample_second_round(state.vk.log_n, rng)
    next_state = VerifierThirdState(
        vk=state.vk, commit=state.commit, tor=list(msg.tor), v=state.v,
        r_v=state.r_v, z_rv_0=p_msg.z_rv_0, z_rv_0_proof=p_msg.proof_for_z_rv_0,
    )
    return next_state, msg


def verify_third_round(state: VerifierThirdState, p_msg: ProverThirdMessage):
    info = p_msg.ml_index_info
    if info.num_variables != state.vk.log_n:
        raise invalid_arg("invalid sumcheck proposal")
    if info.max_multiplicands != state.vk.log_n + 2:
        raise invalid_arg("invalid sumcheck degree proposal")
    ml_verifier = sc.verifier_init(info)
    next_state = VerifierFirstSumcheckState(
        vk=state.vk, commit=state.commit, tor=state.tor, ml_verifier=ml_verifier,
        v=state.v, r_v=state.r_v, z_rv_0=state.z_rv_0,
        z_rv_0_proof=state.z_rv_0_proof,
    )
    return next_state, None


def verify_first_sumcheck_ongoing_round(
    state: VerifierFirstSumcheckState, p_msg: sc.ProverMsg, rng
):
    v_msg = sc.verify_round(state.ml_verifier, p_msg, rng)
    return state, v_msg


def sample_verify_first_sumcheck_ongoing_round(rng) -> sc.VerifierMsg:
    return sc.sample_round(rng)


def verify_first_sumcheck_final_round(
    state: VerifierFirstSumcheckState, p_msg: sc.ProverMsg, rng
):
    v_msg = sc.verify_round(state.ml_verifier, p_msg, rng)
    msg = VerifierThirdMessage(last_random_point=v_msg.randomness)
    next_state = VerifierFourthState(
        vk=state.vk, commit=state.commit, tor=state.tor,
        first_verifier_state=state.ml_verifier, v=state.v, r_v=state.r_v,
        z_rv_0=state.z_rv_0, z_rv_0_proof=state.z_rv_0_proof,
    )
    return next_state, msg


def sample_verify_first_sumcheck_final_round(rng) -> VerifierThirdMessage:
    return VerifierThirdMessage(last_random_point=sc.sample_round(rng).randomness)


def sample_verify_fourth_round(rng) -> VerifierFourthMessage:
    return VerifierFourthMessage(
        r_a=rng.sample_fr(), r_b=rng.sample_fr(), r_c=rng.sample_fr()
    )


def verify_fourth_round(state: VerifierFourthState, p_msg: ProverFourthMessage, rng):
    # subclaim check deferred to round 6 (verifier.rs:316-330)
    msg = sample_verify_fourth_round(rng)
    next_state = VerifierFifthState(
        vk=state.vk, commit=state.commit, r_a=msg.r_a, r_b=msg.r_b, r_c=msg.r_c,
        va=p_msg.va, vb=p_msg.vb, vc=p_msg.vc, tor=state.tor,
        first_verifier_state=state.first_verifier_state, v=state.v,
        r_v=state.r_v, z_rv_0=state.z_rv_0, z_rv_0_proof=state.z_rv_0_proof,
    )
    return next_state, msg


def verify_fifth_round(state: VerifierFifthState, p_msg: ProverFifthMessage):
    info = p_msg.index_info
    if info.num_variables != state.vk.log_n:
        raise invalid_arg("invalid sumcheck proposal")
    if info.max_multiplicands != 2:
        raise invalid_arg("invalid sumcheck degree proposal")
    next_state = VerifierSecondSumcheckState(
        vk=state.vk, commit=state.commit, r_a=state.r_a, r_b=state.r_b,
        r_c=state.r_c, va=state.va, vb=state.vb, vc=state.vc, tor=state.tor,
        first_verifier_state=state.first_verifier_state, v=state.v,
        r_v=state.r_v, z_rv_0=state.z_rv_0, z_rv_0_proof=state.z_rv_0_proof,
        second_verifier_state=sc.verifier_init(info),
    )
    return next_state, None


def verify_second_sumcheck_ongoing_round(
    state: VerifierSecondSumcheckState, p_msg: sc.ProverMsg, rng
):
    v_msg = sc.verify_round(state.second_verifier_state, p_msg, rng)
    return state, v_msg


def sample_verify_second_sumcheck_ongoing_round(rng) -> sc.VerifierMsg:
    return sc.sample_round(rng)


def verify_second_sumcheck_final_round(
    state: VerifierSecondSumcheckState, p_msg: sc.ProverMsg, rng
):
    v_msg = sc.verify_round(state.second_verifier_state, p_msg, rng)
    return state, VerifierFifthMessage(last_random_point=v_msg.randomness)


def sample_verify_second_sumcheck_final_round(rng) -> VerifierFifthMessage:
    return VerifierFifthMessage(last_random_point=sc.sample_round(rng).randomness)


def verify_sixth_round(
    state: VerifierSecondSumcheckState, p_msg: ProverSixthMessage, vp: VerifierParameter
) -> bool:
    """All real checks (verifier.rs:443-512)."""
    vk = state.vk
    log_n = vk.log_n
    log_v = len(state.v).bit_length() - 1

    first_point = list(state.first_verifier_state.randomness)
    second_point = list(state.second_verifier_state.randomness)

    with span("Verify: PC check z(r_v,0..)"):
        r_v_0 = state.r_v + [0] * (log_n - log_v)
        if not pc_verify(vp, state.commit, r_v_0, state.z_rv_0, state.z_rv_0_proof):
            raise invalid_arg("public witness failed in commitment check")

    # v's own MLE evaluated at r_v must equal z_rv_0 (verifier.rs:459-461)
    v_eval = _host_mle_eval(state.v, state.r_v)
    if v_eval != state.z_rv_0:
        raise invalid_arg("public witness is inconsistent with proof")

    # first sumcheck subclaim vs (va vb - vc) * eq(tor, r_x)
    first_sub = sc.check_and_generate_subclaim(state.first_verifier_state, 0)
    r_x = first_sub.point
    eq_rx = 1
    for tor_j, rx_j in zip(state.tor, r_x):
        eq_rx = eq_rx * ell(tor_j, rx_j) % hf.R
    if (state.va * state.vb - state.vc) % hf.R * eq_rx % hf.R != first_sub.expected_evaluation:
        raise WrongWitness("first sumcheck has wrong subclaim")

    # second sumcheck subclaim vs (ra A + rb B + rc C)(r_x, r_y) * z_ry
    z_ry = p_msg.z_ry
    second_claimed = (
        state.r_a * state.va + state.r_b * state.vb + state.r_c * state.vc
    ) % hf.R
    second_sub = sc.check_and_generate_subclaim(
        state.second_verifier_state, second_claimed
    )
    r_y = second_sub.point
    if r_x != first_point or r_y != second_point:
        raise invalid_arg("subclaim points diverge from verifier randomness")
    with span("Verify: matrix evals at (r_x, r_y)"):
        abc = _native.matrix_eval3_native(
            vk.matrix_a.serialize(), vk.matrix_b.serialize(),
            vk.matrix_c.serialize(), r_x, r_y, log_n,
        )
    if abc is None:
        with span("Verify: matrix evals at (r_x, r_y) (device)"):
            abc = matrix_evals_device(vk, r_x, r_y)
    a_rx_ry, b_rx_ry, c_rx_ry = abc
    actual = (
        state.r_a * a_rx_ry % hf.R * z_ry
        + state.r_b * b_rx_ry % hf.R * z_ry
        + state.r_c * c_rx_ry % hf.R * z_ry
    ) % hf.R
    if second_sub.expected_evaluation != actual:
        raise WrongWitness("Cannot verify matrix A, B, C")

    with span("Verify: PC check z(r_y)"):
        if not pc_verify(vp, state.commit, r_y, z_ry, p_msg.proof_for_z_ry):
            raise WrongWitness("Cannot verify z_ry")

    return True


def matrix_evals_device(vk: IndexVK, r_x: List[int], r_y: List[int]):
    """A, B, C (r_x, r_y) on the index's device
    (``spartan_tpu/protocol/verifier.py:307-325``): the eq table of r_x
    (``eq_tables``), each matrix's sparse partial evaluation at r_x, then
    its fold ladder at r_y (K1). Returns three canonical Fr ints."""
    dev = vk.matrix_a.coo[2].device
    eqx = mle.eq_table(fo.encode_mont(FR, r_x, dev)[None])  # (1, 8, n): B = 1
    ry = fo.encode_mont(FR, r_y, dev)
    outs = [mle.eval_at(sparse.eval_on_x_table(m.coo, eqx, 1 << len(r_x))[0], ry)
            for m in (vk.matrix_a, vk.matrix_b, vk.matrix_c)]
    return tuple(fo.decode_mont(FR, torch.cat(outs, dim=1)))


def _host_mle_eval(table: List[int], point: List[int]) -> int:
    t = list(table)
    for r in point:
        t = [
            (t[2 * b] + r * (t[2 * b + 1] - t[2 * b])) % hf.R
            for b in range(len(t) // 2)
        ]
    return t[0]
