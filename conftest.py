"""Test-suite plumbing of the PyTorch port, for every pytest run from the
repository's root.

- The JAX reference's tests named in SLOW_REFERENCE_TESTS are marked
  ``slow``, so tier-1 (``-m 'not slow'``) leaves them out and
  ``-m slow`` runs them on demand. A test is on the list when, alone on a
  cold JAX cache, it or its module's shared fixture takes over 60 s on the
  CPU: nearly all of it XLA compiles of the reference's MSMs, which the
  persistent cache does not save. A port test (``tests/test_torch_*.py``)
  is never on it: a port test that is too slow is made cheaper.
- The port's tests are collected first. Under pytest-xdist's
  ``--dist load`` each worker is sent a run of consecutive items ahead of
  time, and an item sent to a busy worker waits for it, so port tests sent
  behind the reference's slower tests waited while other workers stood
  idle.
- Every test not marked ``slow`` has a limit of TEST_TIME_LIMIT_S, the
  set-up and teardown of its fixtures included. Past it the process is
  ended even inside a native call: faulthandler prints every thread's stack
  and exits. Under pytest-xdist the test is reported as failed by name and
  a new worker takes the rest of the run; without xdist the run ends there.
"""

import faulthandler
import os

import pytest

TEST_TIME_LIMIT_S = 120
_STDERR_FD = pytest.StashKey[int]()

SLOW_REFERENCE_TESTS = (
    # the module's 2^6 setup and prove
    "tests/test_e2e.py::test_prove_verify_roundtrip",
    "tests/test_e2e.py::test_proof_serialization_roundtrip",
    "tests/test_e2e.py::test_verify_rejects_wrong_public_input",
    "tests/test_e2e.py::test_verify_rejects_tampered_proof",
    "tests/test_e2e.py::test_prove_rejects_bad_witness",
    "tests/test_e2e.py::test_verify_native_and_device_matrix_eval_agree",
    # the module's keygen
    "tests/test_commitment.py::test_keygen_vs_naive",
    "tests/test_commitment.py::test_commit_vs_trapdoor",
    "tests/test_commitment.py::test_open_verify_roundtrip",
    "tests/test_commitment.py::test_verify_rejects_wrong_eval",
    "tests/test_interactive.py::test_interactive_round_trip",
    "tests/test_interactive.py::test_verifier_parameter_wire_roundtrip",
    "tests/test_batch.py::test_prove_batch_roundtrip",
    "tests/test_batch.py::test_prove_many_bit_identical",
    "tests/test_curve_msm.py::test_msm_pippenger_small_matches_oracle",
    "tests/test_curve_msm.py::test_msm_many_pippenger_small_matches_oracle",
    "tests/test_curve_msm.py::test_msm_g2_matches_oracle",
    "tests/test_fs_device.py::test_fused_prove_bytes_equal_host_loop",
    "tests/test_parallel.py::test_graft_entry_multichip",
    "tests/test_parallel.py::test_sharded_prove_bit_identical[1]",
    "tests/test_parallel.py::test_sharded_prove_bit_identical[8]",
    # also needs more than 33 GB of host memory
    "tests/test_parallel.py::test_sharded_prove_2e10_bit_identical",
    "tests/test_parallel.py::test_proof_bytes_match_golden_fixture",
)


def is_port_test(item):
    return item.path.name.startswith("test_torch_")


def pytest_configure(config):
    # pytest's capture points fd 2 at a temporary file; keep the real one
    # for the stacks printed at the time limit.
    capture = config.pluginmanager.getplugin("capturemanager")
    if capture is None:
        config.stash[_STDERR_FD] = os.dup(2)
    else:
        with capture.global_and_fixture_disabled():
            config.stash[_STDERR_FD] = os.dup(2)


def pytest_unconfigure(config):
    os.close(config.stash[_STDERR_FD])


# tryfirst: the marks must be in place before `-m` deselects.
@pytest.hookimpl(tryfirst=True)
def pytest_collection_modifyitems(items):
    slow = set(SLOW_REFERENCE_TESTS)
    for item in items:
        if item.nodeid in slow:
            item.add_marker(pytest.mark.slow)
    items.sort(key=lambda item: not is_port_test(item))


@pytest.hookimpl(wrapper=True)
def pytest_runtest_protocol(item, nextitem):
    if item.get_closest_marker("slow") is None:
        faulthandler.dump_traceback_later(
            TEST_TIME_LIMIT_S, exit=True, file=item.config.stash[_STDERR_FD]
        )
    try:
        return (yield)
    finally:
        faulthandler.cancel_dump_traceback_later()
