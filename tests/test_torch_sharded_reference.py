"""The sharded prove of the benchmark's circuit against the benchmark's plain
reference (``portbench/reference/``), and the count of copies between
devices (``parallel/sharded.py``).

- The upstream's test circuit at density 0 (``portbench.generator``, as the
  benchmark's ``spartan-2e18-d0-shard4`` deployment draws it) at 2^6,
  proved over D = 2 and 4 CPU shards with ``sharded_prove.SHARDED_LEVEL``
  lowered so that the largest level of each opening (32 points) runs the
  point-range G2 MSM (``sharded.msm``) beside the commit's G1 MSM: every
  field of the proof equals the reference's, which works the keys out from
  the key seed's trapdoor. The shards share one device, so no copy between
  devices is counted.
- ``sharded.to_device`` counts a copy between two devices under
  ``kernels.LANES["xcard_copy"]`` by its bytes, and nothing on a mesh of one
  device: checked on the CPU and on PyTorch's ``meta`` device, which holds
  shapes without data.
"""

import pytest
import torch
from torch_golden import reuse_openings

from portbench import generator
from portbench.harness import KeyStream
from portbench.reference.spartan import Reference, fields_differing
from spartan_tpu_torch import kernels
from spartan_tpu_torch.parallel import sharded, sharded_prove
from spartan_tpu_torch.protocol.argument import MLArgumentForR1CS

torch.set_num_threads(1)  # small int64 tensors: one intra-op thread is fastest

LOG_N = 6
KEY_SEED, (CIRCUIT_SEED,) = generator.pool(2**40 + 3, 1)


@pytest.fixture(scope="module")
def circuit():
    shape = generator.Shape(LOG_N, 4, 0)
    matrices = generator.matrices(shape, CIRCUIT_SEED)
    v, w = generator.instance(shape, CIRCUIT_SEED, generator.offsets_of(shape, CIRCUIT_SEED))
    pp, _vp = MLArgumentForR1CS.setup(LOG_N, KeyStream(KEY_SEED), "cpu")
    pk = MLArgumentForR1CS.index(*matrices, "cpu")
    return Reference(*matrices, KEY_SEED).prove(v, w), pk, v, w, pp


@pytest.mark.parametrize("d", [2, 4])
def test_sharded_proof_equals_the_reference(circuit, d, monkeypatch):
    reuse_openings(monkeypatch)  # the levels below SHARDED_LEVEL * d are the same at both d
    want, pk, v, w, pp = circuit
    top = 1 << (LOG_N - 1)  # the points of an opening's largest level
    monkeypatch.setattr(sharded_prove, "SHARDED_LEVEL", top // d)
    sizes = []
    real = sharded.msm

    def msm(mesh, points, scalars, *args):
        sizes.append(sum(p.n for p in points))
        return real(mesh, points, scalars, *args)

    monkeypatch.setattr(sharded, "msm", msm)
    kernels.reset_counts()
    proof = MLArgumentForR1CS.prove(pk, v, w, pp, mesh=sharded.make_mesh(devices=["cpu"] * d))
    assert sizes == [1 << LOG_N, top, top]  # the commit, then each opening's largest level
    assert fields_differing(want, proof.serialize()) == []
    assert sharded.XCARD not in kernels.LANES


@pytest.mark.parametrize("devices,counted", [
    (("cpu", "cpu"), {}),
    (("meta", "cpu"), {(256,): 2}),  # block 0 to the first device, then block 1 back to it
])
def test_copies_between_devices_are_counted(devices, counted):
    mesh = sharded.Mesh(tuple(torch.device(d) for d in devices))
    table = torch.arange(8 * 16, dtype=torch.int32).reshape(8, 16)  # two blocks of 8 x 8 int32
    kernels.reset_counts()
    blocks = sharded.shard_table(mesh, table)
    joined = sharded.gather(mesh, blocks)
    assert [b.device for b in blocks] == list(mesh.devices) and joined.device == mesh.first
    assert dict(kernels.LANES.get(sharded.XCARD, {})) == counted
