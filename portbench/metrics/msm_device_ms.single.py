"""msm_device_ms.single: device ms a proof of the operations launched inside
the spans "commit MSM" and "open G2 MSMs" (commitment/scheme.py)."""

from portbench import yardstick

SPANS = {"commit MSM", "open G2 MSMs"}


def read(run):
    return None if run["trace"] is None else yardstick.device_ms_per_proof(run["trace"], SPANS)
