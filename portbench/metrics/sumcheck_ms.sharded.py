"""sumcheck_ms.sharded: host ms a proof of the spans of both sumchecks on
the sharded route's host loop (protocol/argument.py over
parallel/sharded_prove.py): every round's shards, its partial sums
reduced on the first card and its challenge from the host transcript."""

SPANS = ("Prove Sumcheck 1 (sharded)", "Prove Sumcheck 2 (sharded)")


def read(run):
    tr = run["trace"]
    if tr is None or not any(s in tr["spans"] for s in SPANS):
        return None
    return 1e3 * sum(tr["spans"].get(s, 0.0) for s in SPANS) / tr["proofs"]
