"""proofs_per_s.batch: in the traced run, the proofs of the window's calls
made after the traced ones (the profiler off) over the sum of those calls'
latencies; each call is one prove_many, ending in torch.cuda.synchronize()."""


def read(run):
    tr = run["trace"]
    rest = run["latencies"][tr["calls"]:] if tr is not None else []
    if not rest:
        return None
    return run["batch"] * len(rest) / sum(rest)
