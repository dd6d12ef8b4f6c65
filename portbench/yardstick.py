"""The benchmark's yardstick, frozen: the card's rates for the roofline
bound, the kernels' costs, which entry point launched a device kernel, and
the reduction of a profiler trace to busy time, device time by host span
and idle gaps.

The rates are those of an H100 SXM: 3.35 TB/s of device memory (NVIDIA's
data sheet) and 32-bit integer products at 64 IMADs per SM per clock, two
per 32x32->64 product (CUDA C++ Programming Guide, arithmetic instruction
throughput for compute capability 9.0), at the card's top SM clock as
``nvidia-smi`` reports it.
"""

from __future__ import annotations

import json
import re
import subprocess
from pathlib import Path

HERE = Path(__file__).resolve().parent

MEM_BYTES_PER_S = 3.35e12
PRODUCTS_PER_SM_CLOCK = 32


def smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.splitlines()[0].strip()


class Card:
    """The bound of a launch on this card."""

    def __init__(self, sms: int, max_sm_mhz: float):
        self.sms = sms
        self.max_sm_mhz = max_sm_mhz
        self.products_per_s = sms * PRODUCTS_PER_SM_CLOCK * max_sm_mhz * 1e6

    @classmethod
    def read(cls) -> "Card":
        import torch

        return cls(torch.cuda.get_device_properties(0).multi_processor_count, float(smi("clocks.max.sm")))

    def bound_s(self, products: float, nbytes: float) -> float:
        """The least time of work of ``products`` 32x32->64 products that
        must move ``nbytes`` bytes."""
        return max(products / self.products_per_s, nbytes / MEM_BYTES_PER_S)


def costs() -> dict:
    """Each kernel entry point's cost, by name, from ``costs/<entry>.json``."""
    return {p.stem: json.loads(p.read_text()) for p in sorted((HERE / "costs").glob("*.json"))}


def launch_bound_s(card: Card, cost: dict, key: tuple, launches: int) -> float:
    """The bound of ``launches`` launches at ``key`` = (lanes, *int args): a
    lane's products once per repetition (the doublings of a double launch,
    its first int argument), its bytes read and written once."""
    lanes = key[0]
    reps = key[1] if cost.get("repeats_by_first_arg") else 1
    return launches * card.bound_s(cost["products_per_lane"] * lanes * reps, cost["bytes_per_lane"] * lanes)


def entry_point(kernel: str):
    """The program's entry point that launches the device kernel named
    ``kernel`` (as the profiler names it), or None for PyTorch's own."""
    m = re.search(r"team_kernel<(?:\w+::)?(G[12]), \d+, (\d)>", kernel)
    if m:
        return m.group(1).lower() + "_" + ("double", "add", "madd")[int(m.group(2))]
    if re.search(r"inv_(warp|thread)_kernel", kernel):
        return "fp_inv"
    m = re.search(r"pt_kernel<(Fe<FpParams>|FpC|Fp2), (\d)", kernel)
    if m:
        return ("g2_" if m.group(1) == "Fp2" else "g1_") + ("madd", "add", "double")[int(m.group(2))]
    m = re.search(r"\b(sc1_round|prod2_round|sc1_tail|sc2_tail|blake2s_batch)(_b)?_kernel", kernel)
    if m:
        return m.group(1) + (m.group(2) or "")
    m = re.search(r"normalize_(?:warp|thread)_kernel<(\d)>", kernel)
    if m:
        return "g1_normalize" if m.group(1) == "3" else "g2_normalize"
    m = re.search(r"\b(eq_tables|quot_level|quot_tail)_kernel", kernel)
    if m:
        return m.group(1)
    m = re.search(r"fe_mul_cc_kernel<(Fr|Fp)Params>", kernel)
    if m:
        return m.group(1).lower() + "_mul"
    m = re.search(r"fe_binary_kernel<(Fr|Fp)Params, (\d)>", kernel)
    if m:
        return m.group(1).lower() + "_" + ("mul", "add", "sub")[int(m.group(2))]
    return None


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def device_ms_per_proof(trace: dict, spans: set):
    """Device ms a proof of the operations launched inside any of ``spans``
    in a traced run's record, or None where none was."""
    us = [dur for _name, _ts, dur, open_spans in trace["device"] if spans.intersection(open_spans)]
    return sum(us) / 1e3 / trace["proofs"] if us else None


def reduce_trace(events: list, calls: tuple = ()) -> dict:
    """A Chrome trace's events (``torch.profiler``'s export) reduced to
    what the readers take:

    - ``device``: each kernel, copy and set on a card as (name, start us,
      duration us, the host spans around its launch);
    - ``busy_s_by_card``: for each card (the event's ``args.device``, as a
      string), the union of its events' intervals;
    - ``busy_s``: the busiest card's;
    - ``idle``: each gap of the busiest card as (seconds, the innermost
      host span open at the gap's middle), over the traced calls: from the
      start of the first host range named in ``calls`` to the end of the
      last (or of the last device event, if later).

    A device event's spans are the ``record_function`` ranges open on the
    host thread at the moment of its launch (the runtime call with the same
    correlation id)."""
    launch_at = {}
    annotations = {}
    device = []
    for e in events:
        cat = e.get("cat", "")
        if cat in ("cuda_runtime", "cuda_driver"):
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launch_at[corr] = (e.get("tid"), float(e["ts"]))
        elif cat == "user_annotation":
            annotations.setdefault(e.get("tid"), []).append(
                (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e["name"]))
        elif cat in DEVICE_CATS:
            device.append(e)

    # host spans open at a time, by thread: a sweep over each thread's ranges
    queries = {}  # tid -> [(ts, query id)]
    for i, e in enumerate(device):
        tid, ts = launch_at.get((e.get("args") or {}).get("correlation"), (None, None))
        if ts is not None:
            queries.setdefault(tid, []).append((ts, i))
    spans_of = [()] * len(device)
    for tid, qs in queries.items():
        for i, stack in _open_ranges(annotations.get(tid, []), qs):
            spans_of[i] = stack

    by_card = {}
    for e in device:
        card = str((e.get("args") or {}).get("device", 0))
        by_card.setdefault(card, []).append((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))))
    all_ann = [x for v in annotations.values() for x in v]
    bounds = [(a, b) for a, b, name in all_ann if name in calls]
    intervals = [x for iv in by_card.values() for x in iv]
    lo = min([a for a, _b in bounds + intervals], default=0.0)
    hi = max([b for _a, b in bounds + intervals], default=0.0)
    cards = {card: _union(sorted(iv), lo, hi) for card, iv in by_card.items()}
    busy, gaps = max(cards.values(), key=lambda bg: bg[0], default=_union([], lo, hi))
    mids = dict(_open_ranges(all_ann, [((a + b) / 2, j) for j, (a, b) in enumerate(gaps)]))
    idle = [((b - a) / 1e6, (mids.get(j) or ("(no span)",))[-1]) for j, (a, b) in enumerate(gaps)]
    return {
        "device": [(e["name"], float(e["ts"]), float(e.get("dur", 0.0)), spans_of[i]) for i, e in enumerate(device)],
        "busy_s": busy / 1e6,
        "busy_s_by_card": {card: b / 1e6 for card, (b, _g) in sorted(cards.items())},
        "idle": idle,
    }


def _union(intervals, lo: float, hi: float):
    """(busy us, gaps) of sorted (start, end) ``intervals`` over [lo, hi]."""
    busy, end, gaps = 0.0, lo, []
    for a, b in intervals:
        if a > end:
            gaps.append((end, a))
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    if hi > end:
        gaps.append((end, hi))
    return busy, gaps


def _open_ranges(ranges, queries):
    """For each (time, id) of ``queries``, the names of the ``ranges``
    (start, end, name) open at that time, outermost first."""
    ranges = sorted(ranges, key=lambda r: (r[0], -r[1]))
    out, stack, k = [], [], 0
    for t, qid in sorted(queries):
        while k < len(ranges) and ranges[k][0] <= t:
            stack.append(ranges[k])
            k += 1
        stack = [r for r in stack if r[1] >= t]
        out.append((qid, tuple(r[2] for r in stack)))
    return out
