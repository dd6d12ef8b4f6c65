"""The plain reference of the Spartan argument for R1CS over BLS12-381 with
the PST multilinear commitment: the proof that the program must produce,
field by field, from the matrices, the instance and the key seed.

Straight arithmetic on Python integers (vectors as NumPy object arrays),
no kernels, no batching, no multi-scalar multiplication. The commitment
keys are worked out from the trapdoor that the key seed gives: the keys are

    G1 level i, entry b:  g^{eq(t_i.., b)},     G2 level i, entry b:  h^{eq(t_i.., b)}

with g = s_g G1, h = s_h G2 and s_g, s_h, t_0 .. t_{nv-1} the first draws of
``random.Random(key_seed).randrange(r)``. So a commitment to the table f is
g^{f(t)}, and the opening's quotient q_i, committed over the pairwise sums
of level i, is h^{q_i(t_{i+1} ..)}: one scalar multiplication each, on the
multilinear extension evaluated at the trapdoor.

Tables of an nv-variable multilinear extension have variable k on bit k of
the index; folding fixes variable 0 first. The protocol (six prover
messages, a sumcheck of degree log_n + 2 over eq(tor, x) (Az Bz - Cz)(x)
and one of degree 2 over (r_a A + r_b B + r_c C)(r_x, y) z(y)) follows
tsunrise/r1cs-spartan, ``src/ahp/prover.rs`` and ``src/ahp/verifier.rs``.
"""

from __future__ import annotations

import random
from typing import List, Tuple

import numpy as np

from portbench.reference.curve import G1, G2, R, ser_g1, ser_g2
from portbench.reference.transcript import Transcript, fr_bytes, fr_vec_bytes, matrix_bytes, u64

Field = Tuple[str, bytes]  # a named piece of the proof's bytes


def _obj(xs) -> np.ndarray:
    a = np.empty(len(xs), dtype=object)
    a[:] = list(xs)
    return a


def fold(tab: np.ndarray, r: int) -> np.ndarray:
    """Fix variable 0 to r: out[b] = t[2b] + r (t[2b+1] - t[2b])."""
    even, odd = tab[0::2], tab[1::2]
    return (even + r * (odd - even)) % R


def evaluate(tab: np.ndarray, point) -> int:
    for r in point:
        tab = fold(tab, r)
    return int(tab[0])


def eq_table(point) -> np.ndarray:
    """eq(point, x) for every x, variable k on bit k of x."""
    tab = _obj([1])
    for r in point:
        tab = np.concatenate([tab * ((1 - r) % R) % R, tab * r % R])
    return tab


def suffix_tables(point) -> list:
    """S[j] = eq_table(point[j:]) for j = 0 .. len(point); S[len] = [1]."""
    nv = len(point)
    out = [None] * (nv + 1)
    out[nv] = _obj([1])
    for j in range(nv - 1, -1, -1):
        nxt = out[j + 1]
        tab = np.empty(2 * len(nxt), dtype=object)
        tab[0::2] = nxt * ((1 - point[j]) % R) % R
        tab[1::2] = nxt * point[j] % R
        out[j] = tab
    return out


def ell(tor_j: int, t: int) -> int:
    return (tor_j * t + (1 - tor_j) * (1 - t)) % R


_INV2 = pow(2, -1, R)


def _quadratic_at(q0: int, q1: int, q2: int, t: int) -> int:
    """The quadratic through (0, q0), (1, q1), (2, q2), at t."""
    return (q0 * (t - 1) * (t - 2) * _INV2 - q1 * t * (t - 2) + q2 * t * (t - 1) * _INV2) % R


class SparseMatrix:
    """A matrix as COO arrays, with the segment sums by row and by column."""

    def __init__(self, rows, n: int):
        self.n = n
        r_idx, c_idx, vals = [], [], []
        for x, row in enumerate(rows):
            for coeff, y in row:
                r_idx.append(x)
                c_idx.append(y)
                vals.append(coeff % R)
        self.rows = np.asarray(r_idx, dtype=np.int64)
        self.cols = np.asarray(c_idx, dtype=np.int64)
        self.vals = _obj(vals)
        self.by_col = np.argsort(self.cols, kind="stable")

    @staticmethod
    def _segment_sums(keys: np.ndarray, terms: np.ndarray, n: int) -> np.ndarray:
        out = np.zeros(n, dtype=object)
        if len(keys) == 0:
            return out
        starts = np.flatnonzero(np.r_[True, keys[1:] != keys[:-1]])
        out[keys[starts]] = np.add.reduceat(terms, starts) % R
        return out

    def times(self, z: np.ndarray) -> np.ndarray:
        """x -> sum_y M[x, y] z[y]."""
        return self._segment_sums(self.rows, self.vals * z[self.cols], self.n)

    def left_times(self, e: np.ndarray) -> np.ndarray:
        """y -> sum_x M[x, y] e[x]."""
        o = self.by_col
        return self._segment_sums(self.cols[o], self.vals[o] * e[self.rows[o]], self.n)


class Keys:
    """The trapdoor of a key seed and what the reference needs of it."""

    def __init__(self, nv: int, key_seed: int):
        rng = random.Random(key_seed)
        self.nv = nv
        self.s_g = rng.randrange(R)
        self.s_h = rng.randrange(R)
        self.t = [rng.randrange(R) for _ in range(nv)]
        self.g = G1.mul(G1.gen, self.s_g)
        self.h = G2.mul(G2.gen, self.s_h)
        self.suffix = suffix_tables(self.t)

    def g1_key(self, level: int, b: int):
        """The G1 key of level ``level``, entry b: g^{eq(t_level.., b)}."""
        return G1.mul(self.g, int(self.suffix[level][b]))

    def g2_key(self, level: int, b: int):
        return G2.mul(self.h, int(self.suffix[level][b]))

    def g2_comb_key(self, level: int, j: int):
        """The opening's base: the sum of level's entries 2j and 2j + 1."""
        return G2.mul(self.h, int(self.suffix[level + 1][j]))

    def g_mask(self, i: int):
        return G1.mul(self.g, self.t[i])


class Reference:
    """The reference prover of one circuit under one key seed."""

    def __init__(self, a_rows, b_rows, c_rows, key_seed: int):
        n = len(a_rows)
        if n == 0 or n & (n - 1):
            raise ValueError("the matrices' size must be a power of two")
        self.n = n
        self.log_n = n.bit_length() - 1
        self.mats = [SparseMatrix(m, n) for m in (a_rows, b_rows, c_rows)]
        self.keys = Keys(self.log_n, key_seed)
        fs = Transcript()
        for m in (a_rows, b_rows, c_rows):
            fs.absorb(matrix_bytes(m, n))
        self.matrices_state = fs.state

    # -- commitment ----------------------------------------------------------

    def commitment(self, z: np.ndarray) -> bytes:
        """g^{z(t)}, compressed."""
        s = int(np.sum(z * self.keys.suffix[0]) % R)
        return ser_g1(G1.mul(self.keys.g, s))

    def _open(self, z: np.ndarray, point) -> List[Field]:
        """The opening of z at point: its evaluation and one G2 point a
        level, h^{q_i(t_{i+1} ..)}."""
        keys = self.keys
        rem = z
        proofs = []
        for i, p in enumerate(point):
            even, odd = rem[0::2], rem[1::2]
            q = (odd - even) % R
            rem = (even + p * q) % R
            s = int(np.sum(q * keys.suffix[i + 1]) % R)
            proofs.append(ser_g2(G2.mul(keys.h, s)))
        out = [("eval", fr_bytes(int(rem[0]))), ("h", ser_g2(keys.h)), ("levels", u64(len(point)))]
        return out + [(f"level{i}", b) for i, b in enumerate(proofs)]

    # -- the argument --------------------------------------------------------

    def prove(self, v, w, absorb_public_input: bool = True) -> List[Field]:
        """The proof of the instance (v, w), as named fields whose bytes, in
        order, are the whole proof. ``absorb_public_input=False`` leaves v
        out of the transcript: the control, a prover that does not bind its
        challenges to the statement."""
        n, log_n = self.n, self.log_n
        if len(v) + len(w) != n or len(v) & (len(v) - 1):
            raise ValueError("|v| + |w| must be n and |v| a power of two")
        log_v = len(v).bit_length() - 1
        z = _obj([x % R for x in list(v) + list(w)])
        fs = Transcript(self.matrices_state)
        if absorb_public_input:
            fs.absorb(fr_vec_bytes(list(v)))
        fields: List[Field] = []

        def emit(prefix, parts, absorb=True):
            for name, b in parts:
                fields.append((f"{prefix}.{name}", b))
            if absorb:
                fs.absorb(b"".join(b for _n, b in parts))

        # round 1: commit to z
        emit("pm1", [("nv", u64(log_n)), ("commitment", self.commitment(z))])
        r_v = fs.challenges(log_v)
        # round 2: open z at (r_v, 0, .., 0)
        emit("pm2", self._open(z, r_v + [0] * (log_n - log_v)))
        tor = fs.challenges(log_n)
        # round 3: Az, Bz, Cz
        az, bz, cz = (m.times(z) for m in self.mats)
        emit("pm3", [("max_multiplicands", u64(log_n + 2)), ("num_variables", u64(log_n))])
        eq_tor = suffix_tables(tor)

        # sumcheck 1 over eq(tor, x) (Az Bz - Cz)(x)
        fields.append(("sc1.rounds", u64(log_n)))
        pre, rs = 1, []
        for i in range(log_n):
            if i > 0:
                r = fs.challenge()
                rs.append(r)
                pre = pre * ell(tor[i - 1], r) % R
                az, bz, cz = fold(az, r), fold(bz, r), fold(cz, r)
            e = eq_tor[i + 1]
            qs = []
            for t in (0, 1, 2):
                at, bt, ct = ((tab[0::2] + t * (tab[1::2] - tab[0::2])) for tab in (az, bz, cz))
                qs.append(int(np.sum(e * ((at * bt - ct) % R)) % R))
            evals = [pre * ell(tor[i], t) * _quadratic_at(*qs, t) % R for t in range(log_n + 3)]
            emit(f"sc1[{i}]", [("len", u64(len(evals)))] + [(f"e{t}", fr_bytes(x)) for t, x in enumerate(evals)])
        r = fs.challenge()
        r_x = rs + [r]
        va, vb, vc = (int(fold(tab, r)[0]) for tab in (az, bz, cz))
        emit("pm4", [("va", fr_bytes(va)), ("vb", fr_bytes(vb)), ("vc", fr_bytes(vc))])
        r_a, r_b, r_c = fs.challenges(3)

        # round 5: (r_a A + r_b B + r_c C)(r_x, y)
        eqx = eq_table(r_x)
        wy = sum(rr * m.left_times(eqx) for rr, m in zip((r_a, r_b, r_c), self.mats)) % R
        emit("pm5", [("max_multiplicands", u64(2)), ("num_variables", u64(log_n))])

        # sumcheck 2 over W(y) z(y)
        fields.append(("sc2.rounds", u64(log_n)))
        zc, rs2 = z, []
        for i in range(log_n):
            if i > 0:
                r = fs.challenge()
                rs2.append(r)
                wy, zc = fold(wy, r), fold(zc, r)
            evals = []
            for t in (0, 1, 2):
                wt = wy[0::2] + t * (wy[1::2] - wy[0::2])
                zt = zc[0::2] + t * (zc[1::2] - zc[0::2])
                evals.append(int(np.sum(wt * zt) % R))
            emit(f"sc2[{i}]", [("len", u64(3))] + [(f"e{t}", fr_bytes(x)) for t, x in enumerate(evals)])
        r_y = rs2 + [fs.challenge()]
        # round 6: open z at r_y
        emit("pm6", self._open(z, r_y), absorb=False)
        return fields


def split_like(reference: List[Field], proof: bytes) -> List[Tuple[str, bytes, bytes]]:
    """The program's proof bytes cut at the reference's field boundaries:
    (name, reference bytes, program bytes); a length that differs leaves the
    rest of the program's bytes on the last field."""
    out, off = [], 0
    for i, (name, want) in enumerate(reference):
        end = len(proof) if i == len(reference) - 1 else off + len(want)
        out.append((name, want, proof[off:end]))
        off = end
    return out


def fields_differing(reference: List[Field], proof: bytes) -> List[str]:
    """Names of the fields where the program's proof differs from the
    reference's, the length included."""
    return [name for name, want, got in split_like(reference, proof) if want != got]
