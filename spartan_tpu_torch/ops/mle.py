"""Dense multilinear-extension tables over Fr.

Counterpart of ``spartan_tpu/ops/mle.py``: an nv-variable MLE is its
(8, 2^nv) table of Montgomery Fr values, index bit i = variable i, variable
0 the least significant bit; folds fix variable 0 first. The folds'
products, sums and differences go through the Fr kernel K1
(``field.mont_mul``/``add``/``sub``); the eq tables are one launch of K1's
``eq_tables`` a point. The eq tables take B points at once, (B, 8, nv), and
give (B, 8, 2^nv) tables (``spartan_tpu/protocol/batched.py:68``, :87); one
point is B = 1.
"""

from __future__ import annotations

import torch

from spartan_tpu_torch import kernels
from spartan_tpu_torch.ops import field as f
from spartan_tpu_torch.ops.field import FR

__all__ = [
    "fold", "eval_at", "eval_binary", "eq_table", "eq_suffix_tables", "eq_suffix_tables_mont",
    "eq_table_plain", "eq_suffix_tables_plain", "sum_mod", "scale",
]

sum_mod = f.sum_mod


def _halves(table: torch.Tensor):
    return table[..., 0::2], table[..., 1::2]


def fold(table: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Fix variable 0 to r: out[b] = t[2b] + r (t[2b+1] - t[2b]).
    table (8, N), r (8,) or (8, 1) Montgomery -> (8, N / 2)."""
    even, odd = _halves(table)
    diff = f.sub(FR, odd, even)
    return f.add(FR, even, f.mont_mul(FR, diff, r.reshape(FR.nlimb, 1)))


def eval_at(table: torch.Tensor, rs: torch.Tensor) -> torch.Tensor:
    """Evaluate at the point rs (8, nv), variable 0 first -> (8, 1)."""
    t = table
    for i in range(rs.shape[1]):
        t = fold(t, rs[:, i])
    return t


def eval_binary(table: torch.Tensor, idx: int) -> torch.Tensor:
    """The table's entry at the boolean point ``idx`` (bit i = variable i):
    (8, 1)."""
    return table[:, idx : idx + 1]


def scale(table: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Multiply every entry by the scalar s (8,) or (8, 1)."""
    return f.mont_mul(FR, table, s.reshape(FR.nlimb, 1))


def _mul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return f.mont_mul_plain(FR, *torch.broadcast_tensors(a, b))


def eq_table_plain(ts: torch.Tensor) -> torch.Tensor:
    """eq(t, x) over the whole cube: ts (8, nv) Montgomery -> (8, 2^nv),
    out[x] = prod_i (t_i x_i + (1 - t_i)(1 - x_i)), on the plain Fr versions.
    Variable i becomes the most significant bit of the table built so far,
    so blocks stack as [x_i = 0 | x_i = 1]."""
    one = f.ones_mont(FR, (1,), ts.device)
    table = one
    for i in range(ts.shape[1]):
        ti = ts[:, i : i + 1]
        fac = torch.stack([f.sub_plain(FR, one, ti), ti], dim=1)
        table = _mul_plain(table[:, None, :], fac).reshape(FR.nlimb, -1)
    return table


def eq_suffix_tables_plain(ts: torch.Tensor) -> list:
    """``eq_suffix_tables_mont`` on the plain Fr versions. S[nv] is the
    constant 1; S[j]'s variable 0 is ts[j], so the new variable is
    interleaved as the least significant bit."""
    nv = ts.shape[1]
    one = f.ones_mont(FR, (1,), ts.device)
    tables = [None] * (nv + 1)
    tables[nv] = one
    for j in range(nv - 1, -1, -1):
        tj = ts[:, j : j + 1]
        nxt = tables[j + 1]  # (8, M)
        fac = torch.stack([f.sub_plain(FR, one, tj), tj], dim=2)
        tables[j] = _mul_plain(nxt[:, :, None], fac).reshape(FR.nlimb, -1)  # index v = b + 2 x
    return tables


def _eq_sizes(nv: int, tables: int) -> list:
    return [1 << (nv - j) for j in range(tables)]


def _eq_tables(ts: torch.Tensor, tables: int) -> list:
    """Eq tables 0 .. tables - 1 of the suffix set of each point, ts (B, 8,
    nv) Montgomery: one buffer (B, 8 total), a row a point, the tables one
    after the other in it. On the card one launch of K1's ``eq_tables``
    (``csrc/fr_tables.cuh``) a point writes its row; a CPU point takes the
    plain versions. Returns table j as a (B, 8, 2^(nv-j)) view."""
    bsz, _k, nv = ts.shape
    buf = torch.empty((bsz, FR.nlimb * sum(_eq_sizes(nv, tables))), dtype=torch.int32, device=ts.device)
    views = _eq_views(buf, nv, tables)
    for b in range(bsz):
        if ts.device.type == "cpu":
            plain = [eq_table_plain(ts[b])] if tables == 1 else eq_suffix_tables_plain(ts[b])
            for v, t in zip(views, plain):
                v[b].copy_(t)
        else:
            kernels.call("eq_tables", [ts[b].contiguous(), buf[b]], [nv, tables], (nv, tables))
    return views


def _eq_views(buf: torch.Tensor, nv: int, tables: int) -> list:
    """Table j of every row of buf (B, 8 total), the tables one after the
    other in each row: (B, 8, 2^(nv-j)) views."""
    out, off = [], 0
    for m in _eq_sizes(nv, tables):
        out.append(buf[:, FR.nlimb * off : FR.nlimb * (off + m)].view(buf.shape[0], FR.nlimb, m))
        off += m
    return out


def eq_table(ts: torch.Tensor) -> torch.Tensor:
    """eq(t, x) over the whole cube for each point: ts (B, 8, nv)
    Montgomery -> (B, 8, 2^nv), variable i bit i of the index
    (``spartan_tpu/ops/mle.py:89``). One launch a point on the card; a CPU
    point takes ``eq_table_plain``."""
    return _eq_tables(ts, 1)[0]


def eq_suffix_tables_mont(ts: torch.Tensor) -> list:
    """All suffix eq tables S[j] = eq table of ts[j:], j = 0..nv, of each
    point, ts (B, 8, nv) Montgomery (``spartan_tpu/ops/mle.py:123``): S[j]
    (B, 8, 2^(nv-j)), S[j][b][v] has bit k of v for variable j + k, and
    S[nv] is the constant 1; views of one buffer whose row b holds point
    b's tables one after the other. One launch a point on the card; a CPU
    point takes ``eq_suffix_tables_plain``."""
    return _eq_tables(ts, ts.shape[2] + 1)


def eq_suffix_tables(ts_ints, device="cpu") -> list:
    """``eq_suffix_tables_mont`` of one point given as host ints: S[j]
    (8, 2^(nv-j))."""
    return [t[0] for t in eq_suffix_tables_mont(f.encode_mont(FR, ts_ints, device)[None])]
