"""encode_ms.batch: host ms a proof of span "Batch Prove 0: encode z" (the
batch's witness encoding and upload in prove_many)."""


def read(run):
    tr = run["trace"]
    if tr is None or "Batch Prove 0: encode z" not in tr["spans"]:
        return None
    return 1e3 * tr["spans"]["Batch Prove 0: encode z"] / tr["proofs"]
