"""sparse_device_ms.single: device ms a proof of the operations launched
inside the spans of rounds 3 and 5, the sparse matrix products (ops/sparse.py)
and their eq tables."""

from portbench import yardstick

SPANS = {"Prove 3: sparse mat-vec + eq", "Prove 5: eval_on_x + combine"}


def read(run):
    return None if run["trace"] is None else yardstick.device_ms_per_proof(run["trace"], SPANS)
