"""R1CS constraint-system model: sparse matrices and a builder, the port's
copy of ``spartan_tpu/models/r1cs.py``.

A matrix is a list of rows, each a list of ``(coeff, var_index)`` pairs. The
full assignment is ``z = v || w`` with ``v[0] = 1`` (the constant One
variable), so var_index < len(v) addresses a public input and the rest
address witness variables.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple

from spartan_tpu_torch.host import field as hf
from spartan_tpu_torch.utils.errors import invalid_arg

Matrix = List[List[Tuple[int, int]]]  # rows of (coeff, var_index)


@dataclass
class LinearCombination:
    """Sum of coeff * variable terms. Variables are ("instance"|"witness", i)."""

    terms: list = field(default_factory=list)

    def __add__(self, other):
        if isinstance(other, LinearCombination):
            return LinearCombination(self.terms + other.terms)
        return LinearCombination(self.terms + [(1, other)])


def lc(*vars_):
    """lc!() + var + var ..."""
    out = LinearCombination()
    for v in vars_:
        out = out + v
    return out


ONE = ("instance", 0)


class ConstraintSystem:
    """Prove-mode constraint system with assignments: instance and witness
    values, and A/B/C rows built from inlined linear combinations."""

    def __init__(self):
        self.instance_assignment: list = [1]  # One
        self.witness_assignment: list = []
        self.a_rows: Matrix = []
        self.b_rows: Matrix = []
        self.c_rows: Matrix = []

    def new_input_variable(self, value: int):
        idx = len(self.instance_assignment)
        self.instance_assignment.append(value % hf.R)
        return ("instance", idx)

    def new_witness_variable(self, value: int):
        idx = len(self.witness_assignment)
        self.witness_assignment.append(value % hf.R)
        return ("witness", idx)

    def _row(self, comb: LinearCombination) -> list:
        num_v = len(self.instance_assignment)
        acc = {}  # duplicate variables merge, as ark's inline_all_lcs does
        for coeff, (kind, i) in comb.terms:
            col = i if kind == "instance" else num_v + i
            acc[col] = (acc.get(col, 0) + coeff) % hf.R
        return [(c, col) for col, c in sorted(acc.items()) if c != 0]

    def enforce_constraint(self, a: LinearCombination, b: LinearCombination, c: LinearCombination):
        self.a_rows.append(self._row(a))
        self.b_rows.append(self._row(b))
        self.c_rows.append(self._row(c))

    @property
    def num_constraints(self) -> int:
        return len(self.a_rows)

    def to_matrices(self):
        """Rows reference columns as v-index or |v| + w-index; the variable
        count must be final before proving."""
        return self.a_rows, self.b_rows, self.c_rows

    def assignment(self):
        return list(self.instance_assignment), list(self.witness_assignment)

    def is_satisfied(self) -> bool:
        z = self.instance_assignment + self.witness_assignment

        def ev(row):
            return sum(c * z[i] for c, i in row) % hf.R

        return all(ev(ra) * ev(rb) % hf.R == ev(rc)
                   for ra, rb, rc in zip(self.a_rows, self.b_rows, self.c_rows))


def make_matrices_square(cs: ConstraintSystem, num_formatted_variables: int):
    """Pad with 0*0=0 constraints or dummy witnesses until square
    (reference: src/test_utils.rs:81-102)."""
    padding = abs(num_formatted_variables - cs.num_constraints)
    if num_formatted_variables > cs.num_constraints:
        for _ in range(padding):
            cs.enforce_constraint(lc(), lc(), lc())
    else:
        for _ in range(padding):
            cs.new_witness_variable(1)


def validate_matrix(matrix: Matrix, num_constraints: int):
    """Power-of-two and bounds checks (reference: r1cs_reader.rs:38-70), with
    the JAX package's caps on row and column density."""
    if num_constraints & (num_constraints - 1) or num_constraints == 0:
        raise invalid_arg("num of constraints should be power of two")
    if len(matrix) != num_constraints:
        raise invalid_arg("matrix size is inconsistent with number of constraints")
    col_nnz: dict = {}
    for row in matrix:
        for _, idx in row:
            if idx >= num_constraints:
                raise invalid_arg("sparse index out of bound")
            col_nnz[idx] = col_nnz.get(idx, 0) + 1
        if len(row) >= 1 << 31:
            raise invalid_arg("row too dense for segment-sum kernel (>= 2^31 nnz)")
    if col_nnz and max(col_nnz.values()) >= 1 << 31:
        raise invalid_arg("column too dense for segment-sum kernel (>= 2^31 nnz)")


def matrix_to_coo(matrix: Matrix):
    """Flatten a row-list matrix to (rows, cols, vals-ints) COO triples."""
    rows, cols, vals = [], [], []
    for x, row in enumerate(matrix):
        for coeff, y in row:
            rows.append(x)
            cols.append(y)
            vals.append(coeff % hf.R)
    return rows, cols, vals
