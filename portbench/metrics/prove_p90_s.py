"""prove_p90_s: the 90th percentile (nearest rank) of every call's latency
in the window; a call is one prove, ending in torch.cuda.synchronize()."""

import math


def read(run):
    lat = sorted(run["latencies"])
    return lat[math.ceil(0.9 * len(lat)) - 1]
