"""Key persistence (``spartan_tpu_torch/commitment/persist.py``) against
``spartan_tpu.commitment.persist`` on the golden instance's keys (2^5, key
seed 7):

- a file the port writes loads in spartan_tpu to the same arrays, and
  holds the same arrays and meta as the file spartan_tpu writes for the
  same keys;
- a file spartan_tpu writes loads in the port to the same tensors;
- a prove with the reloaded keys gives the golden proof;
- a fmt 1 file (Jacobian combined opening bases) loads normalized and is
  rewritten as fmt 2;
- the verifier parameter's wire bytes equal spartan_tpu's.

Only spartan_tpu's persist module and array conversion run on the JAX
side: its keys are the port's, carried over limb for limb.
"""

import ast
import random

import numpy as np
import pytest
import torch
from torch_golden import GOLDEN, instance, keys as golden_keys, reuse_openings

from spartan_tpu_torch.commitment import persist
from spartan_tpu_torch.host import field as hf
from spartan_tpu_torch.ops import curve as cv
from spartan_tpu_torch.ops import field as fo
from spartan_tpu_torch.ops import fp2
from spartan_tpu_torch.ops.curve import PointBatch
from spartan_tpu_torch.ops.field import FP
from spartan_tpu_torch.protocol.argument import MLArgumentForR1CS

torch.set_num_threads(1)  # small int64 tensors: one intra-op thread is fastest


@pytest.fixture(scope="module")
def keys():
    return golden_keys()


def _tables(pp) -> list:
    return [pb.data for pb in pp.powers_of_g + pp.powers_of_h + pp.powers_of_h_comb]


def _jax_keys(pp, vp):
    """spartan_tpu's PublicParameter and VerifierParameter holding the
    port's keys (numpy arrays of 16-bit limbs)."""
    from spartan_tpu.commitment import PublicParameter as JaxPP
    from spartan_tpu.commitment import VerifierParameter as JaxVP
    from spartan_tpu.ops.curve import PointBatch as JaxPB

    jpb = lambda pb: JaxPB(*cv.to_jax(pb))  # noqa: E731
    jpp = JaxPP(nv=pp.nv, powers_of_g=[jpb(p) for p in pp.powers_of_g],
                powers_of_h=[jpb(p) for p in pp.powers_of_h], g=pp.g, h=pp.h,
                powers_of_h_comb=[jpb(p) for p in pp.powers_of_h_comb])
    return jpp, JaxVP(nv=vp.nv, g=vp.g, h=vp.h, g_mask_random=list(vp.g_mask_random))


def _leaves(jpb) -> list:
    return [np.asarray(a) for leaf in jpb for a in (leaf if isinstance(leaf, tuple) else (leaf,))]


def test_to_jax_inverts_from_jax(keys):
    pp, _vp = keys
    for pb in (pp.powers_of_g[1], pp.powers_of_h[2]):
        leaves = cv.to_jax(pb)
        assert all(a.dtype == np.uint32 and a.shape == (24, pb.n) and int(a.max()) < 1 << 16
                   for a in _leaves(leaves))
        assert torch.equal(cv.from_jax(leaves, pb.group).data, pb.data)


def test_port_file_loads_in_jax_package(keys, tmp_path):
    from spartan_tpu.commitment import persist as jpersist

    pp, vp = keys
    port_file = tmp_path / "port.npz"
    persist.save_keys(str(port_file), pp, vp)
    jpp, jvp = jpersist.load_keys(str(port_file))
    want_pp, want_vp = _jax_keys(pp, vp)
    for mine, want in zip(jpp.powers_of_g + jpp.powers_of_h + jpp.powers_of_h_comb,
                          want_pp.powers_of_g + want_pp.powers_of_h + want_pp.powers_of_h_comb):
        for a, b in zip(_leaves(mine), _leaves(want)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    assert (jpp.nv, jpp.g, jpp.h, jvp.g_mask_random) == (pp.nv, pp.g, pp.h, list(vp.g_mask_random))

    # spartan_tpu's own file of the same keys: the same arrays, the same meta
    jax_file = tmp_path / "jax.npz"
    jpersist.save_keys(str(jax_file), want_pp, want_vp)
    mine, theirs = np.load(port_file), np.load(jax_file)
    assert sorted(mine.files) == sorted(theirs.files)
    for k in theirs.files:
        assert mine[k].dtype == theirs[k].dtype and mine[k].tobytes() == theirs[k].tobytes(), k


def test_jax_file_loads_in_port(keys, tmp_path):
    from spartan_tpu.commitment import persist as jpersist

    pp, vp = keys
    path = tmp_path / "jax.npz"
    jpersist.save_keys(str(path), *_jax_keys(pp, vp))
    pp2, vp2 = persist.load_keys(str(path), "cpu")
    assert all(torch.equal(a, b) for a, b in zip(_tables(pp2), _tables(pp)))
    assert (pp2.nv, pp2.g, pp2.h, pp2.device) == (pp.nv, pp.g, pp.h, torch.device("cpu"))
    assert vp2 == vp


def test_prove_with_reloaded_keys_equals_golden(keys, tmp_path, monkeypatch):
    """The whole prove on the reloaded keys; an opening MSM whose bases and
    scalars equal an earlier proof's in this process is not recomputed."""
    reuse_openings(monkeypatch)
    pp, vp = keys
    path = tmp_path / "keys.npz"
    persist.save_keys(str(path), pp, vp)
    pp2, vp2 = persist.load_keys(str(path), "cpu")
    pk, v, w = instance()
    proof = MLArgumentForR1CS.prove(pk, v, w, pp2)
    assert proof.serialize() == GOLDEN.read_bytes()
    assert MLArgumentForR1CS.verify(pk.vk(), v, proof, vp2) is True


def _jacobian(pb: PointBatch, seed: int) -> PointBatch:
    """The same points with z a random non-zero Fp2 element a lane:
    (x z^2, y z^3, z)."""
    rng = random.Random(seed)
    zs = [fo.encode_mont(FP, [rng.randrange(1, hf.P) for _ in range(pb.n)]) for _ in range(2)]
    z = fp2.make(*zs)
    v = pb.data.permute(1, 0, 2)  # (12, 6, N)
    z2 = fp2.sq2(z)
    x, y = fp2.mul2(v[:, 0:2], z2), fp2.mul2(v[:, 2:4], fp2.mul2(z2, z))
    return PointBatch(torch.cat([x, y, z], dim=1).permute(1, 0, 2).contiguous(), "g2")


def test_fmt1_file_loads_normalized_and_is_rewritten(keys, tmp_path):
    pp, vp = keys
    path = tmp_path / "old.npz"
    persist.save_keys(str(path), pp, vp)
    arrs = dict(np.load(path))
    meta = ast.literal_eval(bytes(arrs["meta"]).decode())
    meta["fmt"] = 1
    arrs["meta"] = np.frombuffer(repr(meta).encode(), dtype=np.uint8)
    for i, pb in enumerate(pp.powers_of_h_comb):
        jac = _jacobian(pb, i)
        assert not torch.equal(jac.data, pb.data)
        for cname, (c0, c1) in zip("xyz", cv.to_jax(jac)):
            arrs[f"hc{i}_{cname}0"], arrs[f"hc{i}_{cname}1"] = c0, c1
    np.savez(path, **arrs)

    pp2, _vp2 = persist.load_keys(str(path), "cpu")
    assert all(torch.equal(a.data, b.data) for a, b in zip(pp2.powers_of_h_comb, pp.powers_of_h_comb))
    again = np.load(path)
    assert ast.literal_eval(bytes(again["meta"]).decode())["fmt"] == 2
    assert np.array_equal(again["hc0_z0"], cv.to_jax(pp.powers_of_h_comb[0])[2][0])


def test_load_keys_defaults_to_the_card(keys, tmp_path):
    import inspect

    assert inspect.signature(persist.load_keys).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card: the default device loads there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        persist.load_keys(str(tmp_path / "missing.npz"))


def test_verifier_parameter_bytes_equal_jax(keys):
    from spartan_tpu.commitment import persist as jpersist

    pp, vp = keys
    data = persist.ser_verifier_parameter(vp)
    assert data == jpersist.ser_verifier_parameter(_jax_keys(pp, vp)[1])
    assert persist.deser_verifier_parameter(data) == vp
