"""The four-card deployment on the CPU: its cell as ``find_cell`` gives it,
its configuration's nonzeros from the frozen generator, and the readers of
the sharded prover's span, device time and cross-card counter.

    python -m pytest portbench/tests/test_portbench_sharded.py -q
"""

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import generator, harness  # noqa: E402

SHARDED_CELL = "r1cs18-d0-sharded4"
SHARDED_METRICS = ["xcard_mb.sharded", "msm_device_ms.sharded", "sumcheck_ms.sharded", "open_ms.sharded"]


def _bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_the_sharded_cell():
    """Four chips, a shard on each; the latency without its 90th percentile
    (9-20 proves a window); the four readers of the sharded prover."""
    spec = harness.find_cell(_bench(), SHARDED_CELL)
    assert spec["cell"]["chips"] == spec["config"]["shards"] == 4
    assert [m["name"] for m in spec["end_to_end"]] == ["prove_s", "peak_mem_gib", "setup_s"]
    assert [m["name"] for m in spec["per_layer"]] == SHARDED_METRICS
    assert spec["traffic"]["entry"] == "single" and spec["traffic"]["trace_calls"] == 4


def test_the_sharded_configuration_has_its_nonzeros():
    config = harness.find_cell(_bench(), SHARDED_CELL)["config"]
    shape = generator.Shape.of(config)
    matrices = generator.matrices(shape, generator.pool(2**40 + 1, 1)[1][0])
    assert shape.n == 1 << 18
    assert sum(len(row) for m in matrices for row in m) == config["nonzeros"] == 1703909


def test_the_sharded_readers():
    """Each reads its number from a traced run's record (2 proofs) and
    nothing without a trace or where the record lacks what it reads, as a
    program without the sharded route's span or counter gives."""
    trace = {
        "proofs": 2,
        "lanes": {"g1_add": {(8,): 3}, "xcard_copy": {(1_000_000,): 3, (500_000,): 2}},
        "spans": {"Prove Sumcheck 1 (sharded)": 0.5, "Prove Sumcheck 2 (sharded)": 0.3,
                  "Prove 2 (sharded)": 0.2, "Prove 6 (sharded)": 0.1, "Prove 3 (sharded)": 9.0},
        "device": [("g1_add", 0.0, 4000.0, ("MLArgumentForR1CS.prove", "commit MSM (sharded)")),
                   ("g2_add", 0.0, 2000.0, ("MLArgumentForR1CS.prove", "open G2 MSMs (sharded)")),
                   ("eq_tables", 0.0, 9000.0, ("MLArgumentForR1CS.prove", "Prove 3 (sharded)"))],
    }
    want = {"xcard_mb.sharded": 2.0, "msm_device_ms.sharded": 3.0, "sumcheck_ms.sharded": 400.0,
            "open_ms.sharded": 150.0}
    bare = {"proofs": 2, "lanes": {"g1_add": {(8,): 3}}, "spans": {"Prove 3": 1.0}, "device": []}
    for name in SHARDED_METRICS:
        read = harness.reader(name)
        assert read({"trace": trace}) == pytest.approx(want[name]), name
        assert read({"trace": None}) is None and read({"trace": bare}) is None, name
