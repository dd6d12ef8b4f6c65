"""encode_ms.single: host ms a proof of span "Prove 1" less its child "Prove 1:
commit z": the witness's encoding and upload (prover.prover_first_round)."""


def read(run):
    tr = run["trace"]
    if tr is None or "Prove 1" not in tr["spans"]:
        return None
    return 1e3 * (tr["spans"]["Prove 1"] - tr["spans"].get("Prove 1: commit z", 0.0)) / tr["proofs"]
