"""R1CS indexer: A, B, C as matrix MLEs with their COO on the chosen device.

Counterpart of ``spartan_tpu/protocol/indexer.py``. Indexing validates each
matrix, keeps the host rows (they are serialized into the Fiat-Shamir
transcript, once, then cached) and uploads one flat COO triple
(rows int64, cols int64, Montgomery vals (8, nnz)) for the sparse kernels.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from spartan_tpu_torch import kernels
from spartan_tpu_torch.models.r1cs import Matrix, matrix_to_coo, validate_matrix
from spartan_tpu_torch.ops import field as fo
from spartan_tpu_torch.ops.field import FR
from spartan_tpu_torch.utils import serialize as ser
from spartan_tpu_torch.utils.errors import invalid_arg


@dataclass
class MatrixExtension:
    """Sparse M as the 2 log_n-variable MLE M(x, y)."""

    rows_list: Matrix
    num_constraints: int
    coo: tuple  # (rows (nnz,) int64, cols (nnz,) int64, vals (8, nnz) Montgomery)
    _ser_cache: bytes = None

    @classmethod
    def new(cls, matrix: Matrix, num_constraints: int, device="cpu") -> "MatrixExtension":
        validate_matrix(matrix, num_constraints)
        rows, cols, vals = matrix_to_coo(matrix)
        if not rows:  # keep the kernels' shapes valid for an empty matrix
            rows, cols, vals = [0], [0], [0]
        coo = (
            torch.from_numpy(np.asarray(rows, np.int64)).to(device),
            torch.from_numpy(np.asarray(cols, np.int64)).to(device),
            fo.encode_mont(FR, vals, device),
        )
        return cls(rows_list=matrix, num_constraints=num_constraints, coo=coo)

    def serialize(self) -> bytes:
        """Transcript bytes of the matrix (cached; the matrix is immutable)."""
        if self._ser_cache is None:
            self._ser_cache = ser.ser_matrix(self.rows_list) + ser.ser_u64(self.num_constraints)
        return self._ser_cache


@dataclass
class IndexPK:
    matrix_a: MatrixExtension
    matrix_b: MatrixExtension
    matrix_c: MatrixExtension
    log_n: int

    def vk(self) -> "IndexVK":
        return IndexVK(self.matrix_a, self.matrix_b, self.matrix_c, self.log_n)


@dataclass
class IndexVK:
    """Verifier key: the same matrices (the verifier is O(nnz))."""

    matrix_a: MatrixExtension
    matrix_b: MatrixExtension
    matrix_c: MatrixExtension
    log_n: int


def index(matrix_a: Matrix, matrix_b: Matrix, matrix_c: Matrix, device="cuda") -> IndexPK:
    """The prover key on ``device`` (the card unless the caller names another)."""
    device = kernels.require_device(device)
    n = len(matrix_a)
    if n == 0 or n & (n - 1):
        raise invalid_arg("Matrix width should be a power of 2.")
    return IndexPK(
        matrix_a=MatrixExtension.new(matrix_a, n, device),
        matrix_b=MatrixExtension.new(matrix_b, n, device),
        matrix_c=MatrixExtension.new(matrix_c, n, device),
        log_n=n.bit_length() - 1,
    )
