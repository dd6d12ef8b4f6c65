"""Rules of the test suite itself.

Tier-1 runs `-m 'not slow'`. The root `conftest.py` marks `slow` exactly the
reference's tests it names in SLOW_REFERENCE_TESTS. A port test
(`tests/test_torch_*.py`) that is too slow is made cheaper, never marked
`slow`; it runs before the reference's tests, and every test left unmarked
runs under the root `conftest.py`'s per-test limit.
"""

import importlib.util
import subprocess
import sys
from pathlib import Path

TESTS = Path(__file__).resolve().parent


def _collect(*args):
    return subprocess.run(
        [sys.executable, "-m", "pytest", *args, "--collect-only", "-q",
         "-p", "no:cacheprovider", "-p", "no:randomly"],
        cwd=TESTS.parent, capture_output=True, text=True, timeout=100,
    )


def test_no_port_test_is_marked_slow():
    files = sorted(str(p) for p in TESTS.glob("test_torch_*.py"))
    assert files
    out = _collect(*files, "-m", "slow")
    # exit code 5: collection worked and every item was deselected
    assert out.returncode == 5, out.stdout + out.stderr
    assert "deselected" in out.stdout, out.stdout


def test_port_tests_are_collected_first():
    first = "tests/test_torch_imports.py"
    out = _collect("tests/test_suite_rules.py", first)
    assert out.returncode == 0, out.stdout + out.stderr
    files = [line.split("::")[0] for line in out.stdout.splitlines() if "::" in line]
    assert set(files) == {first, "tests/test_suite_rules.py"}, out.stdout
    assert files == sorted(files, key=lambda f: f != first), out.stdout


def test_slow_marks_exactly_the_named_reference_tests():
    spec = importlib.util.spec_from_file_location(
        "_root_conftest", TESTS.parent / "conftest.py"
    )
    root_conftest = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(root_conftest)
    named = root_conftest.SLOW_REFERENCE_TESTS
    out = _collect("tests/", "-m", "slow")
    assert out.returncode == 0, out.stdout + out.stderr
    ids = [line for line in out.stdout.splitlines() if "::" in line]
    assert sorted(ids) == sorted(named), out.stdout
