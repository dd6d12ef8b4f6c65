"""The harness on the CPU: the frozen generator against the program's
synthesizer, the files found by name (and a new one found without an
edit), the import rules, the trace reduction, and the run loop driven on
the program's CPU path at 2^5: once sound, and once for each fault a cell
can have, which must read ``correct`` false.

    python -m pytest portbench/tests -q
"""

import ast
import hashlib
import json
import random
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH_DIR = ROOT / "portbench"
sys.path.insert(0, str(ROOT))

from portbench import generator, harness, yardstick  # noqa: E402

CONTRACT_KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}
TINY = {"name": "tiny", "log_n": 5, "num_public": 4, "density": 1}


def _bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


# -- the frozen generator ------------------------------------------------------


@pytest.mark.parametrize("log_n,density,seed", [(5, 1, 3), (6, 0, 11), (8, 229, 2**40 + 7), (7, 64, 9)])
def test_generator_is_the_synthesizer(log_n, density, seed):
    from spartan_tpu_torch.models.synthesizer import generate_circuit_with_random_input

    shape = generator.Shape(log_n, 4, density)
    cs, v, w = generate_circuit_with_random_input(4, shape.num_private, True, density, random.Random(seed))
    assert generator.matrices(shape, seed) == cs.to_matrices()
    assert generator.instance(shape, seed, generator.offsets_of(shape, seed)) == (v, w)


@pytest.mark.parametrize("log_n,density", [(5, 1), (7, 0), (8, 229)])
def test_instances_satisfy_the_circuit(log_n, density):
    """(A z) o (B z) = C z for every row, every seed of a pool."""
    shape = generator.Shape(log_n, 4, density)
    key_seed, seeds = generator.pool(2**33 + 1, 3)
    a, b, c = generator.matrices(shape, seeds[0])
    offsets = generator.offsets_of(shape, seeds[0])
    for s in seeds:
        v, w = generator.instance(shape, s, offsets)
        z = v + w
        assert len(z) == shape.n
        ev = lambda row: sum(coeff * z[col] for coeff, col in row) % generator.R  # noqa: E731
        assert all(ev(ra) * ev(rb) % generator.R == ev(rc) for ra, rb, rc in zip(a, b, c))


def test_pool_is_the_seed():
    assert generator.pool(2**31 + 5, 4) == generator.pool(2**31 + 5, 4)
    key, seeds = generator.pool(2**31 + 5, 16)
    assert len(set(seeds)) == 16 and key not in seeds


# -- files found by name ----------------------------------------------------------


def test_every_file_is_found_by_name():
    bench = _bench()
    costs = yardstick.costs()
    for cell in bench["workloads"]:
        spec = harness.find_cell(bench, cell["name"])
        assert spec["config"]["name"] == cell["config"]
        assert spec["traffic"]["name"] == cell["traffic"]
        assert spec["end_to_end"] and spec["per_layer"]
        assert {"setup_s"} < {m["name"] for m in spec["end_to_end"]}
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(harness.reader(m["name"]))
    for p in (BENCH_DIR / "costs").glob("*.json"):
        assert costs[p.stem]["entry_point"] == p.stem
    used = {c["file"] for c in bench["configs"]}
    assert used == {f"portbench/configs/{p.name}" for p in (BENCH_DIR / "configs").glob("*.json")}


def _digest(tree: Path) -> dict:
    return {str(p.relative_to(tree)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(tree.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_new_files_are_picked_up_without_an_edit(tmp_path):
    """A configuration, a traffic mix, a metric and a kernel's cost dropped
    into a copy of each folder are found by the names a new BENCHMARK.json
    entry gives; no file of the harness changes."""
    shutil.copytree(BENCH_DIR, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    before = _digest(tmp_path / "portbench")
    bench = _bench()
    (tmp_path / "portbench" / "configs" / "spartan-2e12-d64.json").write_text(
        json.dumps({**TINY, "name": "spartan-2e12-d64", "log_n": 12, "density": 64}))
    (tmp_path / "portbench" / "traffic" / "closed1-pool4.json").write_text(
        json.dumps({"name": "closed1-pool4", "entry": "single", "batch": 1, "pool": 4,
                    "warmup_calls": 1, "trace_calls": 2}))
    (tmp_path / "portbench" / "metrics" / "calls_per_s.py").write_text(
        "def read(run):\n    return run['calls'] / run['window_s']\n")
    (tmp_path / "portbench" / "costs" / "g3_add.json").write_text(
        json.dumps({"entry_point": "g3_add", "layer": "point", "products_per_lane": 1, "bytes_per_lane": 1,
                    "repeats_by_first_arg": False}))
    bench["configs"].append({"name": "spartan-2e12-d64", "source": "x", "file": "portbench/configs/spartan-2e12-d64.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "r1cs12-d64-single", "config": "spartan-2e12-d64",
                               "traffic": "closed1-pool4", "chips": 1, "why": "x"})
    bench["end_to_end"].append({"name": "calls_per_s", "unit": "1/s", "better": "higher", "bound": 0.05,
                                "source": "host_clock", "workloads": ["r1cs12-d64-single"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    probe = (
        "import json, sys; sys.path.insert(0, sys.argv[1]);"
        "from portbench import harness, yardstick;"
        "b = json.load(open(sys.argv[1] + '/BENCHMARK.json'));"
        "s = harness.find_cell(b, 'r1cs12-d64-single');"
        "r = harness.reader('calls_per_s')({'calls': 6, 'window_s': 2.0});"
        "print(json.dumps([s['config']['log_n'], s['traffic']['pool'], sorted(m['name'] for m in s['end_to_end']),"
        " r, 'g3_add' in yardstick.costs(), harness.__file__]))"
    )
    out = subprocess.run([sys.executable, "-c", probe, str(tmp_path)], capture_output=True, text=True, check=True)
    log_n, pool, e2e, rate, cost, where = json.loads(out.stdout)
    assert (log_n, pool, rate, cost) == (12, 4, 3.0, True)
    assert e2e == ["calls_per_s", "peak_mem_gib", "setup_s"]
    assert where.startswith(str(tmp_path))
    after = _digest(tmp_path / "portbench")
    assert {k: v for k, v in after.items() if k in before} == before
    assert len(after) == len(before) + 4


# -- imports ---------------------------------------------------------------------------


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_module_imports_jax_or_the_jax_package():
    for p in BENCH_DIR.rglob("*.py"):
        found = _imports(p) & {"jax", "jaxlib", "flax", "spartan_tpu"}
        assert not found, f"{p} imports {found}"


def test_the_reference_imports_nothing_of_the_program():
    for p in (BENCH_DIR / "reference").rglob("*.py"):
        assert "spartan_tpu_torch" not in _imports(p), p
    probe = ("import sys; sys.path.insert(0, sys.argv[1]); import portbench.reference.spartan, portbench.control;"
             "print(sorted({m.split('.')[0] for m in sys.modules} & {'spartan_tpu_torch', 'spartan_tpu', 'jax', 'torch'}))")
    out = subprocess.run([sys.executable, "-c", probe, str(ROOT)], capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


# -- the yardstick -------------------------------------------------------------------------


def test_trace_reduction():
    """Device events are attributed to the host spans open at their launch;
    busy time is the union of their intervals; gaps take the innermost
    span open at their start."""
    ev = [
        {"cat": "user_annotation", "name": "call", "ts": 1, "dur": 204, "tid": 1},
        {"cat": "user_annotation", "name": "Prove 1", "ts": 1, "dur": 99, "tid": 1},
        {"cat": "user_annotation", "name": "commit MSM", "ts": 10, "dur": 40, "tid": 1},
        {"cat": "user_annotation", "name": "Prove 2", "ts": 100, "dur": 100, "tid": 1},
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 12, "dur": 2, "tid": 1, "args": {"correlation": 1}},
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 60, "dur": 2, "tid": 1, "args": {"correlation": 2}},
        {"cat": "cuda_runtime", "name": "cudaMemcpyAsync", "ts": 150, "dur": 2, "tid": 1, "args": {"correlation": 3}},
        {"cat": "kernel", "name": "void team_kernel<G2, 8, 1>(int)", "ts": 20, "dur": 30, "args": {"correlation": 1}},
        {"cat": "kernel", "name": "other", "ts": 40, "dur": 30, "args": {"correlation": 2}},
        {"cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 160, "dur": 10, "args": {"correlation": 3}},
    ]
    red = yardstick.reduce_trace(ev, ("call",))
    spans = {name: s for name, _ts, _d, s in red["device"]}
    assert spans["void team_kernel<G2, 8, 1>(int)"] == ("call", "Prove 1", "commit MSM")
    assert spans["other"] == ("call", "Prove 1") and spans["Memcpy DtoH"] == ("call", "Prove 2")
    assert red["busy_s"] == pytest.approx(60e-6)
    # the gaps: before the first kernel, between the kernels and the copy, after the copy
    assert red["idle"] == [(pytest.approx(19e-6), "commit MSM"), (pytest.approx(90e-6), "Prove 2"),
                           (pytest.approx(35e-6), "Prove 2")]
    assert yardstick.entry_point("void team_kernel<G2, 8, 1>(int)") == "g2_add"


def test_launch_bound():
    card = yardstick.Card(sms=132, max_sm_mhz=1980.0)
    cost = yardstick.costs()["g2_double"]
    one = yardstick.launch_bound_s(card, cost, (8, 1), 1)
    assert yardstick.launch_bound_s(card, cost, (8, 4), 1) == pytest.approx(4 * one)
    assert one == pytest.approx(8 * 4608 / (132 * 32 * 1980e6))


# -- the run loop on the CPU ------------------------------------------------------------------


def _spec(cell: str, **traffic):
    spec = harness.find_cell(_bench(), cell)
    spec["config"] = dict(TINY)
    spec["traffic"] = {"warmup_calls": 1, "trace_calls": 1, **traffic}
    return spec


SINGLE = dict(entry="single", batch=1, pool=2)
BATCH = dict(entry="batch", batch=4, pool=8)


def test_run_loop_on_the_cpu(capsys):
    """One run at 2^5 on the program's CPU path: the contract's keys, the
    device the CPU, correct."""
    res = harness.run_cell(_spec("r1cs16-d0-single", **SINGLE), 2**31 + 99, 0.01, False, "cpu")
    harness.print_result(res)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(line) == CONTRACT_KEYS and list(line)[-1] == "checks"
    assert line["device"]["platform"] == "cpu" and line["device"]["kind"] == "cpu"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    assert set(line["metrics"]) == {"prove_s", "prove_p90_s", "peak_mem_gib", "setup_s"}


def test_the_command_without_a_card_prints_no_result():
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "r1cs16-d0-single", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 3 and out.stdout == ""
    assert "torch.cuda.is_available() is False" in out.stderr


def _stale(real):
    """A prover that returns its state unchanged: the first proof it made,
    for every call after."""
    made = []

    def prove(*a, **k):
        if not made:
            made.append(real(*a, **k))
        return made[0]

    return prove


def _half_batch(real):
    """prove_many that proves the first half of the batch and hands those
    proofs out for the second half too."""
    def prove_many(pk, instances, pp):
        half = real(pk, list(instances)[: len(instances) // 2], pp)
        return (half * 2)[: len(instances)]

    return prove_many


def _altered(real, slots=slice(None)):
    """A sumcheck phase whose first message's first evaluation is off by one,
    in the instances ``slots`` picks where the phase is batched."""
    def phase(*a, **k):
        res = real(*a, **k)
        for r in res[slots] if isinstance(res, list) else [res]:
            r.evals[0][0] = (r.evals[0][0] + 1) % generator.R
        return res

    return phase


@pytest.mark.parametrize("fault", ["stale_state", "altered_answer", "half_batch", "altered_answer_batch",
                                   "altered_answer_one_slot"])
def test_faults_read_incorrect(fault, monkeypatch):
    """The run loop with the timed path broken underneath: correct false."""
    from spartan_tpu_torch.protocol import argument, batched, fused

    if fault == "stale_state":
        monkeypatch.setattr(argument.MLArgumentForR1CS, "prove", staticmethod(_stale(argument.MLArgumentForR1CS.prove)))
        spec = _spec("r1cs16-d0-single", **SINGLE)
    elif fault == "altered_answer":
        monkeypatch.setattr(fused, "sc2_phase", _altered(fused.sc2_phase))
        spec = _spec("r1cs16-d0-single", **SINGLE)
    elif fault == "half_batch":
        monkeypatch.setattr(batched, "prove_many", _half_batch(batched.prove_many))
        spec = _spec("r1cs16-d0-batch64", **BATCH)
    elif fault == "altered_answer_batch":
        monkeypatch.setattr(fused, "sc2_phase_b", _altered(fused.sc2_phase_b))
        spec = _spec("r1cs16-d0-batch64", **BATCH)
    else:  # one slot of every batch, the last
        monkeypatch.setattr(fused, "sc2_phase_b", _altered(fused.sc2_phase_b, slice(-1, None)))
        spec = _spec("r1cs16-d0-batch64", **BATCH)
    res = harness.run_cell(spec, 2**32 + 3, 0.01, False, "cpu")
    assert res["correct"] is False and res["failed"] >= 1


def test_full_picks_cover_every_slot():
    """One proof of every slot position of a call, and CHECK_IN_FULL more."""
    from portbench import check

    rng = random.Random(2**35 + 1)
    picks = check.full_picks(5 * 64, 64, rng)
    assert {k % 64 for k in picks} == set(range(64))
    assert len(picks) == 64 + check.CHECK_IN_FULL
    assert len(check.full_picks(7, 1, rng)) == min(7, 1 + check.CHECK_IN_FULL)
    assert check.full_picks(3, 1, rng) == [0, 1, 2]


@pytest.mark.parametrize("cell,traffic", [("r1cs16-d0-single", SINGLE), ("r1cs16-d0-batch64", BATCH)])
def test_the_control_reads_incorrect(cell, traffic):
    """The control in the program's place, through the run's own comparison."""
    from portbench import control

    res = harness.run_cell(_spec(cell, **traffic), 2**32 + 5, 0.01, False, "cpu",
                           program_class=control.ControlProgram)
    assert res["correct"] is False and res["failed"] >= 1
    assert res["checks"]["fields_differing"]["value"] > 0
    assert res["checks"]["keys_differing"]["value"] == 0


def test_batch_rate_leaves_out_the_traced_calls():
    read = harness.reader("proofs_per_s.batch")
    run = {"batch": 64, "latencies": [20.0, 8.0, 8.0], "trace": {"calls": 1}}
    assert read(run) == 8.0
    assert read({**run, "trace": None}) is None
    assert read({**run, "trace": {"calls": 3}}) is None
