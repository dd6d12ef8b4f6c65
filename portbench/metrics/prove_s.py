"""prove_s: the measured window's length over the proofs completed in it
(one client, a closed loop of MLArgumentForR1CS.prove)."""


def read(run):
    return run["window_s"] / run["proofs"]
