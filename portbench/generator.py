"""The frozen generator of the benchmark's instances: the R1CS test circuit
of tsunrise/r1cs-spartan (``TestSynthesizer``, src/data_structures/
constraints.rs:8-111, padded square as src/test_utils.rs:51-102) as the
program's ``models/synthesizer.py`` draws it, in two parts:

- ``matrices``: A, B, C of the circuit, built once a run. With 4 public
  inputs every circuit seed gives the same matrices (the chain's offset is
  always public input 3), so one index serves every instance of a pool;
- ``instance``: the public input v and the witness w of one circuit seed,
  the values alone, without building the constraint system again.

Both draw from ``random.Random(seed)`` in the synthesizer's order (the
reference's quirk included: the first assignment is pushed twice), so the
circuit is the one ``generate_circuit_with_random_input`` returns for that
seed. ``pool`` derives the key seed and the circuit seeds of a run from
``--seed``.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import List, Tuple

R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001


@dataclass(frozen=True)
class Shape:
    log_n: int
    num_public: int
    density: int

    @property
    def n(self) -> int:
        return 1 << self.log_n

    @property
    def num_private(self) -> int:
        return self.n - self.num_public

    @property
    def num_sparse(self) -> int:
        return (self.num_private - 1) * (510 - self.density) // 510

    @classmethod
    def of(cls, config: dict) -> "Shape":
        return cls(config["log_n"], config["num_public"], config["density"])


def _draws(shape: Shape, seed: int):
    """(public values, the offset index of each chain constraint) of a seed,
    in the synthesizer's order of draws."""
    if shape.num_public <= 3 or shape.num_public & (shape.num_public - 1):
        raise ValueError("the public input must be a power of two above 3")
    rng = random.Random(seed)
    publics = [rng.randrange(R) for _ in range(shape.num_public - 1)]
    offsets = [rng.randrange(2, shape.num_public - 1) for _ in range(shape.num_sparse)]
    return publics, offsets


def _merged(terms) -> list:
    """A linear combination's row: duplicate columns merged, sorted, zeros
    dropped (ark's inline_all_lcs)."""
    acc = {}
    for coeff, col in terms:
        acc[col] = (acc.get(col, 0) + coeff) % R
    return [(c, col) for col, c in sorted(acc.items()) if c]


def matrices(shape: Shape, seed: int):
    """(A, B, C) as rows of (coeff, column); column j < num_public is public
    input j, the rest witness j - num_public. Rows of the dense squares are
    one shared list each for A and B."""
    npub = shape.num_public
    _publics, offsets = _draws(shape, seed)
    # assignment columns in the synthesizer's order: a, a (the quirk), the rest of the publics
    cols = [1, 1] + list(range(3, npub))
    a_col, b_col = 1, 2
    a_rows, b_rows, c_rows = [], [], []
    for i, k in enumerate(offsets):
        off = cols[k]
        c_col = npub + i
        if i % 2:
            a_rows.append(_merged([(1, a_col)]))
            b_rows.append(_merged([(1, b_col), (1, off)]))
        else:
            a_rows.append(_merged([(1, a_col), (1, b_col), (1, off)]))
            b_rows.append([(1, 0)])
        c_rows.append([(1, c_col)])
        cols.append(c_col)
        a_col, b_col = b_col, c_col
    dense = _merged([(1, col) for col in cols])
    for i in range(shape.num_sparse, shape.num_private):
        a_rows.append(dense)
        b_rows.append(dense)
        c_rows.append([(1, npub + i)])
    for _ in range(shape.n - len(a_rows)):  # square: 0 * 0 = 0 rows
        a_rows.append([])
        b_rows.append([])
        c_rows.append([])
    return a_rows, b_rows, c_rows


def instance(shape: Shape, seed: int, offsets: list) -> Tuple[List[int], List[int]]:
    """(v, w) of circuit seed ``seed``, whose circuit must be the one of
    ``offsets`` (``offsets_of`` of the seed that built the matrices)."""
    publics, mine = _draws(shape, seed)
    if mine != offsets:
        raise ValueError(f"circuit seed {seed} gives other matrices")
    a_val, b_val = publics[0], publics[1]
    vals = [a_val, a_val] + publics[2:]  # the quirk: a pushed twice
    w = []
    for i, k in enumerate(offsets):
        off = vals[k]
        c_val = a_val * ((b_val + off) % R) % R if i % 2 else (a_val + b_val + off) % R
        w.append(c_val)
        vals.append(c_val)
        a_val, b_val = b_val, c_val
    dense = sum(vals) % R
    w.extend([dense * dense % R] * (shape.num_private - shape.num_sparse))
    return [1] + publics, w


def offsets_of(shape: Shape, seed: int) -> list:
    return _draws(shape, seed)[1]


def pool(seed: int, size: int):
    """(key seed, circuit seeds) of a run: the first draws of
    ``random.Random(seed)``, so one ``--seed`` gives one pool."""
    rng = random.Random(seed)
    key_seed = rng.randrange(1 << 63)
    return key_seed, [rng.randrange(1 << 63) for _ in range(size)]
