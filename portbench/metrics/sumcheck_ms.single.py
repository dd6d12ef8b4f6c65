"""sumcheck_ms.single: host ms a proof of the spans of both sumcheck phases on
the device transcript (protocol/fused.py); each ends in its one copy to the
host, so the span covers the phase's device work."""

SPANS = ("Prove Sumcheck 1 (fused)", "Prove Sumcheck 2 (fused)")


def read(run):
    tr = run["trace"]
    if tr is None or not any(s in tr["spans"] for s in SPANS):
        return None
    return 1e3 * sum(tr["spans"].get(s, 0.0) for s in SPANS) / tr["proofs"]
