"""open_ms.sharded: host ms a proof of the sharded route's two openings,
spans "Prove 2 (sharded)" and "Prove 6 (sharded)": the quotients on the
first card, the large levels' point-range G2 MSMs over the cards and the
small levels' banded MSMs."""

SPANS = ("Prove 2 (sharded)", "Prove 6 (sharded)")


def read(run):
    tr = run["trace"]
    if tr is None or not any(s in tr["spans"] for s in SPANS):
        return None
    return 1e3 * sum(tr["spans"].get(s, 0.0) for s in SPANS) / tr["proofs"]
