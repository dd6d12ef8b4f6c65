"""msm_device_ms.sharded: device ms a proof, summed over the cards, of the
operations launched inside the spans of the sharded commit and the sharded
openings' G2 MSMs (parallel/sharded_prove.py)."""

from portbench import yardstick

SPANS = {"commit MSM (sharded)", "open G2 MSMs (sharded)"}


def read(run):
    return None if run["trace"] is None else yardstick.device_ms_per_proof(run["trace"], SPANS)
