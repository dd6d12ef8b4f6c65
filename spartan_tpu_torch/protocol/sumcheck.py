"""Multilinear sumcheck: wire types, the generic prover and the host
verifier.

Counterpart of ``spartan_tpu/protocol/sumcheck.py``: the ``IndexInfo``,
``ProverMsg`` and ``VerifierMsg`` wire types; the generic prover over a
sum of products of dense MLE tables (``prover_init``, ``prove_round``), on
the Fr kernel K1; and the lazy verifier (store every round, check
g_1(0) + g_1(1) == claimed sum and g_{i+1}(0) + g_{i+1}(1) == g_i(r_i) at
the end, return the subclaim). The Spartan prover's own rounds are in
``spartan_tpu_torch/ops/sumcheck.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import torch

from spartan_tpu_torch.host import field as hf
from spartan_tpu_torch.ops import field as fo
from spartan_tpu_torch.ops import mle
from spartan_tpu_torch.ops.field import FR
from spartan_tpu_torch.utils import serialize as ser
from spartan_tpu_torch.utils.errors import SumCheckError, invalid_arg


# ---------------------------------------------------------------------------
# Wire structures
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class IndexInfo:
    """Sumcheck index info sent to the verifier
    (reference: ml_sumcheck IndexInfo, checked at src/ahp/verifier.rs:226)."""

    max_multiplicands: int
    num_variables: int

    def serialize(self) -> bytes:
        return ser.ser_u64(self.max_multiplicands) + ser.ser_u64(self.num_variables)


@dataclass(frozen=True)
class ProverMsg:
    """Round univariate evaluated at 0..=deg (host ints)."""

    evaluations: List[int]

    def serialize(self) -> bytes:
        return ser.ser_fr_vec(self.evaluations)


@dataclass(frozen=True)
class VerifierMsg:
    randomness: int


# ---------------------------------------------------------------------------
# Univariate interpolation (host)
# ---------------------------------------------------------------------------


def interpolate_uni_poly(evals: List[int], r: int) -> int:
    """Evaluate at r the unique degree-<=d poly through (i, evals[i]), i=0..d."""
    d = len(evals) - 1
    result = 0
    for j, yj in enumerate(evals):
        num, den = 1, 1
        for k in range(d + 1):
            if k == j:
                continue
            num = num * ((r - k) % hf.R) % hf.R
            den = den * (j - k)
        result = (result + yj * num % hf.R * hf.fr_inv(den % hf.R)) % hf.R
    return result


# ---------------------------------------------------------------------------
# Generic prover (products of dense MLE tables, on the tables' device)
# ---------------------------------------------------------------------------


@dataclass
class ProverState:
    """Linear state machine: one fold a received challenge."""

    products: List[List[torch.Tensor]]  # each factor: (8, 2^nv) Montgomery
    num_variables: int
    max_multiplicands: int
    round: int = 0
    randomness: List[int] = field(default_factory=list)


def prover_init(products: List[List[torch.Tensor]], num_variables: int) -> ProverState:
    """The prover of sum_b sum_j prod_k products[j][k](b)."""
    if not products:
        raise invalid_arg("empty combination")
    for prod in products:
        for t in prod:
            if t.shape[1] != 1 << num_variables:
                raise invalid_arg("table size mismatch")
    return ProverState(
        products=[list(p) for p in products],
        num_variables=num_variables,
        max_multiplicands=max(len(p) for p in products),
    )


def index_info(state: ProverState) -> IndexInfo:
    return IndexInfo(state.max_multiplicands, state.num_variables)


def prove_round(state: ProverState, v_msg: Optional[VerifierMsg]) -> ProverMsg:
    """Fold every table by the challenge (none in round 0), then the
    round polynomial at t = 0..max_multiplicands: each product's factors at
    t by adding their odd-minus-even steps, multiplied, summed mod r.
    Mutates ``state``."""
    if state.round >= state.num_variables:
        raise invalid_arg("sumcheck prover already finished")
    if state.round > 0:
        if v_msg is None:
            raise invalid_arg("expected verifier randomness")
        r = fo.encode_mont(FR, [v_msg.randomness], state.products[0][0].device)
        state.randomness.append(v_msg.randomness)
        state.products = [[mle.fold(t, r) for t in prod] for prod in state.products]
    elif v_msg is not None:
        raise invalid_arg("first round takes no randomness")

    npoints = state.max_multiplicands + 1
    evals = [0] * npoints
    for prod in state.products:
        evens = [t[:, 0::2] for t in prod]
        steps = [fo.sub(FR, t[:, 1::2], e) for t, e in zip(prod, evens)]
        cur = evens
        for tpoint in range(npoints):
            if tpoint > 0:
                cur = [fo.add(FR, c, s) for c, s in zip(cur, steps)]
            acc = cur[0]
            for factor in cur[1:]:
                acc = fo.mont_mul(FR, acc, factor)
            evals[tpoint] = (evals[tpoint] + fo.decode_mont(FR, mle.sum_mod(acc))[0]) % hf.R
    state.round += 1
    return ProverMsg(evaluations=evals)


# ---------------------------------------------------------------------------
# Verifier (host, lazy)
# ---------------------------------------------------------------------------


@dataclass
class VerifierState:
    index_info: IndexInfo
    round: int = 0
    polynomials: List[List[int]] = field(default_factory=list)
    randomness: List[int] = field(default_factory=list)
    finished: bool = False


@dataclass(frozen=True)
class SubClaim:
    point: List[int]
    expected_evaluation: int


def verifier_init(info: IndexInfo) -> VerifierState:
    return VerifierState(index_info=info)


def sample_round(rng) -> VerifierMsg:
    return VerifierMsg(randomness=rng.sample_fr())


def verify_round(state: VerifierState, p_msg: ProverMsg, rng) -> Optional[VerifierMsg]:
    """Store the message, echo fresh randomness (checks deferred)."""
    if state.finished:
        raise invalid_arg("sumcheck verifier already finished")
    if len(p_msg.evaluations) != state.index_info.max_multiplicands + 1:
        raise SumCheckError("wrong number of round-poly evaluations")
    msg = sample_round(rng)
    state.polynomials.append(list(p_msg.evaluations))
    state.randomness.append(msg.randomness)
    state.round += 1
    if state.round == state.index_info.num_variables:
        state.finished = True
    return msg


def check_and_generate_subclaim(state: VerifierState, claimed_sum: int) -> SubClaim:
    """All deferred round checks + final subclaim
    (reference: check_and_generate_subclaim, used at src/ahp/verifier.rs:465,486)."""
    if not state.finished:
        raise invalid_arg("sumcheck verifier has not seen all rounds")
    expected = claimed_sum % hf.R
    for i, evals in enumerate(state.polynomials):
        if (evals[0] + evals[1]) % hf.R != expected:
            raise SumCheckError(f"round {i + 1}: g(0)+g(1) != expected sum")
        expected = interpolate_uni_poly(evals, state.randomness[i])
    return SubClaim(point=list(state.randomness), expected_evaluation=expected)
