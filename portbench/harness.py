"""One run of one cell: set up the program, warm it up, measure a closed
loop for a fixed time, trace it if asked, check what it produced against
the plain reference, and build the result line.

Everything that belongs to one configuration, traffic mix, metric or
kernel is a file found by its name: ``configs/<config>.json`` (the
circuit), ``traffic/<traffic>.json`` (the entry point, batch and pool of
the one client's closed loop), ``metrics/<metric>.py`` (a reader:
``read(run)`` returns a number, or None where it finds nothing to read; a
metric ``<name>.<part>`` without a file of its own is read by
``metrics/<name>.py``) and ``costs/<entry>.json`` (a kernel's products and
bytes a lane). ``BENCHMARK.json`` names them.

A configuration's ``"shards": D`` (1 where it is left out) is its
deployment's layout: one prove split over D cards, a shard on each, through
``MLArgumentForR1CS.prove(..., mesh=...)``. Its cells ask for D chips. Every
card of the mesh is synchronized and measured: the memory peak is the
fullest card's, and a traced run's busy time is read card by card.
"""

from __future__ import annotations

import functools
import gc
import importlib.util
import json
import os
import random
import sys
import tempfile
import time
from pathlib import Path

from portbench import check, generator, yardstick
from portbench.reference.spartan import Reference

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "spartan_tpu")
R = generator.R


ENTRY_RANGES = ("MLArgumentForR1CS.prove", "prove_many")  # the profiler ranges of Program.call


class NoDevice(RuntimeError):
    """The cell's cards are not there."""


class KeyStream:
    """``sample_fr()`` for the program's setup: the draws of
    ``random.Random(key_seed).randrange(r)``."""

    def __init__(self, key_seed: int):
        self._rng = random.Random(key_seed)

    def sample_fr(self) -> int:
        return self._rng.randrange(R)


def find_cell(bench: dict, name: str) -> dict:
    """The cell ``name`` of BENCHMARK.json with its configuration, traffic
    and the metrics it reports: {"cell", "config", "traffic", "end_to_end",
    "per_layer"}."""
    cells = {c["name"]: c for c in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    cell = cells[name]
    cfg = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = json.loads((ROOT / cfg["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text())
    shards = config.get("shards", 1)
    if cell["chips"] != shards:
        raise SystemExit(f"workload {name!r} asks for {cell['chips']} chips, its configuration "
                         f"{cell['config']!r} has shards {shards}: a cell takes a card a shard")
    if shards > 1 and traffic["entry"] == "batch":
        raise SystemExit(f"workload {name!r}: shards {shards} with the batch traffic {cell['traffic']!r}; "
                         "prove_many has no mesh")

    def mine(m):
        return name in m.get("workloads", [name])

    return {
        "cell": cell,
        "config": config,
        "traffic": traffic,
        "end_to_end": [m for m in bench["end_to_end"] if mine(m)],
        "per_layer": [m for m in bench["per_layer"] if mine(m)],
    }


def reader(metric: str):
    """``metrics/<metric>.py``'s ``read``; for ``<name>.<part>`` without a
    file of its own, ``metrics/<name>.py``'s."""
    path = HERE / "metrics" / f"{metric}.py"
    if not path.exists() and "." in metric:
        path = HERE / "metrics" / f"{metric.rsplit('.', 1)[0]}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


class Program:
    """The system under test: the port's set-up and its two entry points,
    ``prove_one`` and ``prove_many``. With the configuration's shards D > 1,
    keys and index live on the mesh's first device and ``prove_one`` proves
    over the mesh; ``cards`` are the devices the run synchronizes and
    measures."""

    def __init__(self, config: dict, traffic: dict, seed: int, device: str):
        import torch

        from spartan_tpu_torch import kernels
        from spartan_tpu_torch.protocol.argument import MLArgumentForR1CS

        self.torch, self.device = torch, torch.device(device)
        self.cuda = self.device.type == "cuda"
        shape = generator.Shape.of(config)
        self.shape, self.traffic = shape, traffic
        self.key_seed, seeds = generator.pool(seed, traffic["pool"])
        t = time.perf_counter()
        if self.cuda:
            kernels.load()
            log(f"kernel library ready in {time.perf_counter() - t:.1f} s (built here: "
                f"{kernels.build_seconds is not None})")
        self.matrices = generator.matrices(shape, seeds[0])
        offsets = generator.offsets_of(shape, seeds[0])
        self.instances = {}
        for i, s in enumerate(seeds):
            self.instances[i] = generator.instance(shape, s, offsets)
        self.mesh, home, self.cards = None, device, [self.device]
        shards = config.get("shards", 1)
        if shards > 1:
            self.mesh = self.make_mesh(shards)
            home, self.cards = self.mesh.first, list(dict.fromkeys(self.mesh.devices))
        t = time.perf_counter()
        self.pp, self.vp = MLArgumentForR1CS.setup(shape.log_n, KeyStream(self.key_seed), home)
        self.pk = MLArgumentForR1CS.index(*self.matrices, home)
        self.sync()
        log(f"keys and index in {time.perf_counter() - t:.2f} s")
        from spartan_tpu_torch.protocol import batched

        self.prove_one, self.prove_many = MLArgumentForR1CS.prove, batched.prove_many
        if self.mesh is not None:
            self.prove_one = functools.partial(MLArgumentForR1CS.prove, mesh=self.mesh)

    def make_mesh(self, shards: int):
        """The mesh one prove is split over: a shard on each of cuda:0 ..
        cuda:D-1, or D shards on the CPU."""
        from spartan_tpu_torch.parallel.sharded import make_mesh

        return make_mesh(shards) if self.cuda else make_mesh(devices=[self.device] * shards)

    def sync(self) -> None:
        if self.cuda:
            for card in self.cards:
                self.torch.cuda.synchronize(card)

    def reset_peak(self) -> None:
        if self.cuda:
            for card in self.cards:
                self.torch.cuda.reset_peak_memory_stats(card)

    def peak_bytes(self) -> int:
        """The allocator's peak since the last reset on the fullest card."""
        return max(self.torch.cuda.max_memory_allocated(card) for card in self.cards) if self.cuda else 0

    def call(self, k: int) -> list:
        """Call number k of the closed loop: [(instance id, Proof)]. The
        call is a profiler range named after the entry point, so a trace
        tells the host's time in it outside the program's own spans."""
        from torch.profiler import record_function

        tr = self.traffic
        if tr["entry"] == "single":
            inst = k % tr["pool"]
            v, w = self.instances[inst]
            with record_function("MLArgumentForR1CS.prove"):
                return [(inst, self.prove_one(self.pk, v, w, self.pp))]
        bsz = tr["batch"]
        first = (k % (tr["pool"] // bsz)) * bsz
        ids = list(range(first, first + bsz))
        with record_function("prove_many"):
            return list(zip(ids, self.prove_many(self.pk, [self.instances[i] for i in ids], self.pp)))

    def free(self) -> None:
        del self.pk, self.pp
        if self.cuda:
            self.torch.cuda.empty_cache()


def _traced(program: Program):
    """Start tracing: the program's spans and launch counts from zero and
    the profiler on. Returns stop(), which gives the trace's record."""
    from torch.profiler import ProfilerActivity, profile

    from spartan_tpu_torch import kernels, timers

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if program.cuda else [])
    program.sync()
    timers.reset()
    kernels.reset_counts()
    prof = profile(activities=acts)
    prof.start()
    t0 = time.perf_counter()

    def stop(reduce: bool = True) -> dict:
        program.sync()
        window = time.perf_counter() - t0
        prof.stop()
        if not reduce:
            return None
        spans = dict(timers.SPANS)
        lanes = {k: dict(v) for k, v in kernels.LANES.items()}
        fd, path = tempfile.mkstemp(suffix=".json", prefix="portbench-trace-")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as fh:
                events = json.load(fh).get("traceEvents", [])
        finally:
            os.unlink(path)
        red = yardstick.reduce_trace(events, ENTRY_RANGES)
        del events
        return {"window_s": window, "spans": spans, "lanes": lanes, **red}

    return stop


def run_cell(spec: dict, seed: int, seconds: float, trace: bool, device: str = "cuda",
             t_start: float = None, program_class=Program) -> dict:
    """One run of the cell ``spec`` (``find_cell``'s). Returns the result
    line's object; its "checks" hold each number compared with its limit.
    ``program_class`` puts another prover in the program's place (the
    control, ``control.py``)."""
    t_start = time.perf_counter() if t_start is None else t_start
    import torch

    import spartan_tpu_torch  # noqa: F401  the system under test; without it there is no run

    cell, config, traffic = spec["cell"], spec["config"], spec["traffic"]
    cuda = torch.device(device).type == "cuda"
    if cuda:
        if not torch.cuda.is_available():
            raise NoDevice("torch.cuda.is_available() is False")
        if torch.cuda.device_count() < cell["chips"]:
            raise NoDevice(f"{torch.cuda.device_count()} cards, the cell asks for {cell['chips']}")
        card = yardstick.Card.read()
        log(f"card: {torch.cuda.get_device_name(0)}, power.limit {yardstick.smi('power.limit')} W, "
            f"clocks.max.sm {card.max_sm_mhz:.0f} MHz, {card.sms} SMs")
    else:
        card = None
    program = program_class(config, traffic, seed, device)
    warm = traffic["warmup_calls"]
    for k in range(warm):
        program.call(k)
        program.sync()
    if trace:  # the profiler's first start (CUPTI's) belongs to set-up
        _traced(program)(reduce=False)
    # The pool, matrices, keys and index are set-up's: freeze them, so that
    # no full collection inside the window walks them.
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.2f} s; measuring {seconds} s")

    setup_peak = program.peak_bytes()
    program.reset_peak()
    latencies, outs, traced = [], [], None
    stop = None
    program.sync()
    t0 = time.perf_counter()
    k = 0  # the window's calls go on from the warm-up's instances
    while time.perf_counter() - t0 < seconds:
        if trace and k == 0:
            stop = _traced(program)
        t = time.perf_counter()
        outs.append(program.call(warm + k))
        program.sync()
        latencies.append(time.perf_counter() - t)
        k += 1
        if stop is not None and k == traffic["trace_calls"]:
            traced, stop = stop(), None
    if stop is not None:
        traced = stop()
    window_s = time.perf_counter() - t0
    window_peak = program.peak_bytes()
    log(f"window {window_s:.3f} s, {k} calls; call latencies s: {[round(x, 4) for x in latencies[:200]]}")
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"modules loaded in the run's process: {found}")

    proofs = [(inst, p.serialize()) for out in outs for inst, p in out]
    rng = random.Random(seed)
    sampled = check.sample_keys(program.pp, program.vp, program.shape.log_n, rng)
    instances, matrices, key_seed = program.instances, program.matrices, program.key_seed
    program.free()
    del outs
    t = time.perf_counter()
    ref = Reference(*matrices, key_seed)
    res = check.check_run(ref, instances, proofs, traffic["batch"], rng, sampled)
    log(f"reference check in {time.perf_counter() - t:.1f} s")

    run = {
        "setup_s": setup_s, "window_s": window_s, "latencies": latencies, "calls": k,
        "proofs": len(proofs), "batch": traffic["batch"], "peak_bytes": window_peak,
        "trace": None, "card": card,
    }
    metrics = {}
    if trace:
        run["trace"] = dict(traced, calls=min(k, traffic["trace_calls"]),
                            proofs=min(k, traffic["trace_calls"]) * traffic["batch"],
                            costs=yardstick.costs())
        chosen = spec["per_layer"]
    else:
        chosen = spec["end_to_end"]
    for m in chosen:
        value = reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    checks = {
        "keys_differing": {"value": len(res["keys_differing"]), "limit": 0},
        "commitments_differing": {"value": len(res["commitments_differing"]), "limit": 0},
        "fields_differing": {"value": len(res["fields_differing"]), "limit": 0},
        "proofs_checked_in_full": {"value": res["proofs_checked"], "at_least": 1},
    }
    correct = (all(c["value"] <= c["limit"] for c in checks.values() if "limit" in c)
               and res["proofs_checked"] >= 1)
    for what in ("keys_differing", "commitments_differing", "fields_differing"):
        for item in res[what][:20]:
            log(f"differs: {what}: {item}")
    result = {
        "correct": correct,
        "attempted": len(proofs),
        "failed": res["failed"],
        "metrics": metrics,
        "device": {
            "platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
            "count": cell["chips"],
            "memory_peak_bytes": max(setup_peak, window_peak),
        },
    }
    if trace:
        tr = run["trace"]
        # averaged over the cards the run uses; idle_pct and the breakdown
        # read the busiest card
        result["device"]["busy_s"] = sum(tr["busy_s_by_card"].values()) / cell["chips"]
        result["device"]["busy_s_by_card"] = tr["busy_s_by_card"]
        result["device"]["window_s"] = tr["window_s"]
        result["breakdown"] = breakdown(tr)
    result["checks"] = checks
    return result


def breakdown(tr: dict) -> dict:
    """The device operations that took most time (by the program's entry
    point where one launched them) and the idle time by what the host was
    doing (the innermost span open at each gap's middle), ten of each."""
    ops, idle = {}, {}
    for name, _ts, dur, _spans in tr["device"]:
        key = yardstick.entry_point(name) or name[:96]
        ops[key] = ops.get(key, 0.0) + dur / 1e6
    for secs, label in tr["idle"]:
        idle[label] = idle.get(label, 0.0) + secs
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]  # noqa: E731
    return {"device_ops": top(ops), "idle_gaps": top(idle)}


def print_result(result: dict) -> None:
    for name, c in result["checks"].items():
        bound = f"limit {c['limit']}" if "limit" in c else f"at least {c['at_least']}"
        log(f"check {name}: {c['value']} ({bound})")
    print(json.dumps(result), flush=True)
