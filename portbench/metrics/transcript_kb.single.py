"""transcript_kb.single: KB a proof that the host's Fiat-Shamir transcript
absorbed in the traced calls: the program's counter kernels.LANES["fs_absorb"],
feeds by (bytes,), which utils/transcript.py's Blake2sRng.feed adds to on
every feed (the public input and the messages the host absorbs; the
matrices too, where a prove absorbs them)."""


def read(run):
    tr = run["trace"]
    feeds = (tr or {}).get("lanes", {}).get("fs_absorb")
    if not feeds:
        return None
    return sum(key[0] * n for key, n in feeds.items()) / 1e3 / tr["proofs"]
