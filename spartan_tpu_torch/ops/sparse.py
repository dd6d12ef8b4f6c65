"""Sparse R1CS-matrix products: gather, Montgomery multiply, segment sum.

Counterpart of ``spartan_tpu/ops/sparse.py`` (``sum_over_y`` :122,
``eval_on_x_table`` :132). Both are one kernel shape over the flat COO
triple (rows, cols, vals):

    out[s] = sum over entries e with scatter[e] = s of vals[e] * table[gather[e]]

- ``sum_over_y``:      gather = col (z), scatter = row
- ``eval_on_x_table``: gather = row (eq(r_x, .)), scatter = col

Each takes B instances' tables (B, 8, N) with the one shared COO (one
instance is B = 1): one product launch and one ``index_add_`` for a chunk
of instances (``spartan_tpu/protocol/batched.py:105-157`` for B > 1). The
products come from the Fr kernel K1. The segment sum adds their 16-bit
halves into int64 accumulators with ``index_add_``, exact for any segment
below 2^47 entries, and ``reduce_wide`` reduces once. The JAX package's
two-stage path for dense segments (``sparse.py:47-120``) existed only
because its accumulators were uint32; there is nothing to port.
"""

from __future__ import annotations

import torch

from spartan_tpu_torch.ops import field as f
from spartan_tpu_torch.ops.field import FR

__all__ = ["gather_mul_segsum", "sum_over_y", "eval_on_x_table"]

# instances x nonzeros of one pass at most: its 16-bit halves take 16 int64
# words a lane (2 GiB at the cap), the accumulators and the products less;
# at 2^16 (142 k nonzeros a matrix) B = 64 is one pass
SEGSUM_B_LANES = 1 << 24


def gather_mul_segsum(gather_idx, scatter_idx, vals, table, n_out: int) -> torch.Tensor:
    """gather_idx, scatter_idx (nnz,) int64; vals (8, nnz) Montgomery; table
    (B, 8, N) Montgomery, each instance's. Returns (B, 8, n_out) canonical
    Montgomery, in chunks of instances of at most SEGSUM_B_LANES products."""
    bsz, nnz = table.shape[0], gather_idx.shape[0]
    step = max(1, SEGSUM_B_LANES // max(1, nnz))
    out = torch.empty((bsz, FR.nlimb, n_out), dtype=torch.int32, device=table.device) if bsz > 1 else None
    for b0 in range(0, bsz, step):
        t = table[b0 : b0 + step].transpose(0, 1)  # (8, c, N)
        prods = f.mont_mul(FR, vals[:, None, :], t.index_select(2, gather_idx))
        halves = f._to16(prods)  # (16, c, nnz) int64
        acc = torch.zeros((FR.nsub, t.shape[1], n_out), dtype=torch.int64, device=table.device)
        acc.index_add_(2, scatter_idx, halves)
        part = f.reduce_wide(FR, acc).transpose(0, 1)  # (c, 8, n_out)
        if out is None:
            return part  # one instance: (1, 8, n_out) is contiguous as it is, no copy
        out[b0 : b0 + step] = part
    return out


def sum_over_y(coo, z, n: int) -> torch.Tensor:
    """x -> sum_y M[x, y] z[y] of each instance's z, (B, 8, n)."""
    rows, cols, vals = coo
    return gather_mul_segsum(cols, rows, vals, z, n)


def eval_on_x_table(coo, eqx, n: int) -> torch.Tensor:
    """y -> M(r_x, y) = sum_x M[x, y] eq(r_x, x) of each instance's
    eq(r_x, .), (B, 8, n)."""
    rows, cols, vals = coo
    return gather_mul_segsum(rows, cols, vals, eqx, n)
