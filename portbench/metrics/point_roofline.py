"""point_roofline: the point kernels' (K3, K4: the entry points
whose cost file says layer "point") summed bound over their summed device
time, in %. A launch's bound is yardstick.launch_bound_s of its lanes and
int arguments (kernels.LANES over the traced calls) on this card."""

from portbench import yardstick


def read(run):
    tr, card = run["trace"], run["card"]
    if tr is None or card is None:
        return None
    point = {k: c for k, c in tr["costs"].items() if c["layer"] == "point"}
    bound = sum(yardstick.launch_bound_s(card, point[e], key, n)
                for e, shapes in tr["lanes"].items() if e in point for key, n in shapes.items())
    dev_us = sum(dur for name, _ts, dur, _s in tr["device"] if yardstick.entry_point(name) in point)
    if not dev_us or not bound:
        return None
    return 100.0 * bound / (dev_us / 1e6)
