"""The reader of the argument driver's counter, ``transcript_kb.single``: KB
a proof the host's Fiat-Shamir transcript absorbed in the traced calls,
from ``kernels.LANES["fs_absorb"]``. That no prove absorbs the matrices
is the program's test, ``tests/test_torch_transcript_prefix.py``.

    python -m pytest portbench/tests/test_portbench_transcript.py -q
"""

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402

METRIC = "transcript_kb.single"
SINGLE_CELLS = ["r1cs16-d0-single", "r1cs11-d229-single"]


def _bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_the_single_cells_report_it():
    for cell in SINGLE_CELLS:
        spec = harness.find_cell(_bench(), cell)
        assert METRIC in [m["name"] for m in spec["per_layer"]], cell


def test_the_reader():
    """KB a proof from a synthetic record of 2 proofs; nothing without a
    trace, or where the record lacks the counter, as the parent's program
    gives."""
    read = harness.reader(METRIC)
    trace = {"proofs": 2, "lanes": {"g1_add": {(8,): 3}, "fs_absorb": {(136,): 2, (616,): 2, (16,): 4}}}
    assert read({"trace": trace}) == pytest.approx((2 * 136 + 2 * 616 + 4 * 16) / 1e3 / 2)
    assert read({"trace": None}) is None
    assert read({"trace": {"proofs": 2, "lanes": {"g1_add": {(8,): 3}}}}) is None

