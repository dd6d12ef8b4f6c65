"""idle_pct.single, idle_pct.batch: the share of the traced window, in %, in
which no kernel, copy or set ran on the card (the union of their intervals)."""


def read(run):
    tr = run["trace"]
    if tr is None or not tr["device"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
