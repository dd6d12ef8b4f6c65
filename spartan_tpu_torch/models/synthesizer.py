"""Random test-circuit synthesizer, the port's copy of
``spartan_tpu/models/synthesizer.py`` (reference: ``TestSynthesizer``,
src/data_structures/constraints.rs:8-111, and
``generate_circuit_with_random_input``, src/test_utils.rs:51-79): chains of
mul/add constraints with a density knob, then dense square constraints.

It draws from ``rng`` in the same order as the JAX package, so one seed
gives the same circuit in both. The reference's quirk is kept: it pushes
``(a_val, a_var)`` twice instead of ``(b_val, b_var)`` (constraints.rs:46-47),
which shapes which variables are picked as offsets.
"""

from __future__ import annotations

import random

from spartan_tpu_torch.host import field as hf
from spartan_tpu_torch.models.r1cs import (
    ONE,
    ConstraintSystem,
    LinearCombination,
    lc,
    make_matrices_square,
)


def synthesize(cs: ConstraintSystem, num_private: int, num_public: int, density: int, rng: random.Random):
    if num_public <= 3:
        raise ValueError("number of public variables should be greater than 3")
    assignments = []
    a_val = rng.randrange(hf.R)
    a_var = cs.new_input_variable(a_val)
    assignments.append((a_val, a_var))

    b_val = rng.randrange(hf.R)
    b_var = cs.new_input_variable(b_val)
    assignments.append((a_val, a_var))  # reference quirk: a pushed twice

    for _ in range(num_public - 3):
        val = rng.randrange(hf.R)
        var = cs.new_input_variable(val)
        assignments.append((val, var))

    num_sparse = (num_private - 1) * (510 - density) // 510

    for i in range(num_sparse):
        offset_val, offset_var = assignments[rng.randrange(2, num_public - 1)]
        if i % 2 != 0:
            c_val = a_val * ((b_val + offset_val) % hf.R) % hf.R
            c_var = cs.new_witness_variable(c_val)
            cs.enforce_constraint(lc(a_var), lc(b_var, offset_var), lc(c_var))
        else:
            c_val = (a_val + b_val + offset_val) % hf.R
            c_var = cs.new_witness_variable(c_val)
            cs.enforce_constraint(lc(a_var, b_var, offset_var), lc(ONE), lc(c_var))
        assignments.append((c_val, c_var))
        a_val, a_var = b_val, b_var
        b_val, b_var = c_val, c_var

    for _ in range(num_sparse, num_private):
        # dense square constraint: the sum of all assigned variables on both
        # mul inputs (reference constraints.rs:52-60), built as one term list
        dense_terms = [(1, var) for _val, var in assignments]
        c_val = sum(val for val, _var in assignments) % hf.R
        c_var = cs.new_witness_variable(c_val * c_val % hf.R)
        cs.enforce_constraint(LinearCombination(list(dense_terms)),
                              LinearCombination(list(dense_terms)), lc(c_var))


def generate_circuit_with_random_input(num_public: int, num_private: int, pad_to_square: bool,
                                       density: int, rng: random.Random):
    """A random satisfiable circuit; returns (cs, v, w)."""
    cs = ConstraintSystem()
    synthesize(cs, num_private, num_public, density, rng)
    if pad_to_square:
        make_matrices_square(cs, num_public + num_private)
    v, w = cs.assignment()
    return cs, v, w
