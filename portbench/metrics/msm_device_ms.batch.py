"""msm_device_ms.batch: device ms a proof of the operations launched inside
the spans of prove_many's commits and both openings (protocol/batched.py)."""

from portbench import yardstick

SPANS = {"Batch Prove 1: commits", "Batch Prove 2: opens z(r_v,0..)", "Batch Prove 6: opens z(r_y)"}


def read(run):
    return None if run["trace"] is None else yardstick.device_ms_per_proof(run["trace"], SPANS)
