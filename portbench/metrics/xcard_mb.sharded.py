"""xcard_mb.sharded: MB a proof copied from one card to another in the
traced calls: the program's counter kernels.LANES["xcard_copy"], launches
by (bytes,), which parallel/sharded.py adds to at every copy between two
devices (table and point blocks, gathers, partial sums and points)."""


def read(run):
    tr = run["trace"]
    copies = (tr or {}).get("lanes", {}).get("xcard_copy")
    if not copies:
        return None
    return sum(key[0] * n for key, n in copies.items()) / 1e6 / tr["proofs"]
