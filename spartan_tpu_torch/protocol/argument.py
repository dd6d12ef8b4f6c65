"""Non-interactive argument driver: ``MLArgumentForR1CS``.

Counterpart of ``spartan_tpu/protocol/argument.py``: the transcript absorbs
the serialized A, B, C and the public input, then every prover message, and
samples each verifier challenge from the same stream. The proof bytes equal
the JAX package's. The chain state after A, B and C depends on the index
alone: ``index`` computes it once (``IndexPK.fs_state``), and ``prove`` and
``verify`` resume their transcripts from it, then absorb the public input.

Two routes through the sumchecks, with the same bytes, chosen as the JAX
package chooses (:32-36): by default each sumcheck phase, prover round 4
included, runs with the transcript on the device (``protocol/fused.py``),
and the host transcript resumes from the chain state the phase returns;
with ``SPARTAN_DEVICE_FS`` set to ``0`` or ``false`` the host samples every
challenge after decoding every round (the host loop).

``setup`` and ``index`` build on the card unless the caller names another
device (the CPU tests pass ``"cpu"``); ``prove`` runs on the device of
``pp``, or sharded over a mesh of devices (``mesh=``: the host loop on
``parallel/sharded_prove.py``'s route); ``verify`` runs on the host.
"""

from __future__ import annotations

import os
from typing import List, Tuple

from spartan_tpu_torch.commitment import PublicParameter, VerifierParameter, keygen
from spartan_tpu_torch.models.r1cs import Matrix
from spartan_tpu_torch.protocol import fused
from spartan_tpu_torch.protocol import prover as pr
from spartan_tpu_torch.protocol import sumcheck as sc
from spartan_tpu_torch.protocol import verifier as vr
from spartan_tpu_torch.protocol.indexer import IndexPK, IndexVK, index as _index
from spartan_tpu_torch.protocol.proof import Proof
from spartan_tpu_torch.timers import span
from spartan_tpu_torch.utils import serialize as ser
from spartan_tpu_torch.utils.errors import invalid_arg
from spartan_tpu_torch.utils.transcript import Blake2sRng


def _use_device_fs() -> bool:
    """The device-resident transcript unless SPARTAN_DEVICE_FS is "0" or
    "false" (the JAX package's switch)."""
    return os.environ.get("SPARTAN_DEVICE_FS", "1") not in ("0", "false")


def _transcript(fs_state: bytes, v: List[int]) -> Blake2sRng:
    """The transcript resumed from the index's chain state after A, B, C,
    with the public input absorbed."""
    fs = Blake2sRng.setup()
    fs.set_state(fs_state)
    fs.feed(ser.ser_fr_vec(v))
    return fs


class MLArgumentForR1CS:
    """Non-interactive Spartan argument for R1CS over BLS12-381."""

    @staticmethod
    def setup(nv: int, rng, device="cuda") -> Tuple[PublicParameter, VerifierParameter]:
        """Trusted setup on ``device``; the trapdoor is dropped. ``rng``
        provides ``sample_fr()``."""
        pp, vp, _t = keygen(nv, rng, device)
        return pp, vp

    @staticmethod
    def index(matrix_a: Matrix, matrix_b: Matrix, matrix_c: Matrix, device="cuda") -> IndexPK:
        return _index(matrix_a, matrix_b, matrix_c, device)

    @staticmethod
    def prove(pk: IndexPK, v: List[int], w: List[int], pp: PublicParameter, mesh=None) -> Proof:
        """Non-interactive prove on the device of ``pp``. With ``mesh`` (a
        ``parallel.sharded.Mesh``, whose first device holds ``pk`` and
        ``pp``), the commit and opening MSMs and both sumchecks run sharded
        over the mesh on the host loop (``parallel/sharded_prove.py``): the
        same proof bytes at any device count."""
        if pk.matrix_a.coo[2].device != pp.device:
            raise invalid_arg(f"index on {pk.matrix_a.coo[2].device}, parameters on {pp.device}")
        route = pr.ONE_DEVICE
        if mesh is not None:
            from spartan_tpu_torch.parallel import sharded_prove

            if mesh.first != pp.device:
                raise invalid_arg(f"parameters on {pp.device}, the mesh's first device is {mesh.first}")
            route = sharded_prove.route(mesh)
        label = route.label
        log_n = pk.log_n
        fs = _transcript(pk.fs_state, v)
        log_v = len(v).bit_length() - 1

        ps = pr.prover_init(pk, v, w)
        with span("Prove 1" + label):
            ps, pm1 = pr.prover_first_round(ps, pp, route)
        fs.feed(pm1.serialize())
        r_v = fs.sample_fr_vec(log_v)

        with span("Prove 2" + label):
            ps, pm2 = pr.prover_second_round(ps, r_v, pp, route)
        fs.feed(pm2.serialize())
        tor = fs.sample_fr_vec(log_n)

        with span("Prove 3" + label):
            ps, pm3 = pr.prover_third_round(ps, tor, route)
        fs.feed(pm3.serialize())

        device_fs = mesh is None and _use_device_fs()
        if device_fs:
            with span("Prove Sumcheck 1 (fused)"):  # the phases' batch axis at B = 1
                res1 = fused.sc1_phase(ps.az[None], ps.bz[None], ps.cz[None], [t[None] for t in ps.suffix], [ps.tor],
                                       [fs.get_state()])[0]
            sc1_msgs = [sc.ProverMsg(evaluations=e) for e in res1.evals]
            fs.set_state(res1.state)
            pm4 = pr.ProverFourthMessage(*res1.vabc)
            ps = pr.ProverFifthState(pk=pk, z=ps.z, r_x=res1.rs)
            r_a, r_b, r_c = res1.rabc
        else:
            with span("Prove Sumcheck 1" + label):
                sc1_msgs = []
                v_msg = None
                for _ in range(log_n - 1):
                    ps, pm = pr.prove_first_sumcheck_round(ps, v_msg, route)
                    fs.feed(pm.serialize())
                    sc1_msgs.append(pm)
                    v_msg = vr.sample_verify_first_sumcheck_ongoing_round(fs)
                ps, pm = pr.prove_first_sumcheck_round(ps, v_msg, route)
            fs.feed(pm.serialize())
            sc1_msgs.append(pm)
            vm3 = vr.sample_verify_first_sumcheck_final_round(fs)

            with span("Prove 4" + label):
                ps, pm4 = pr.prove_fourth_round(ps, vm3.last_random_point, route)
            fs.feed(pm4.serialize())
            vm4 = vr.sample_verify_fourth_round(fs)
            r_a, r_b, r_c = vm4.r_a, vm4.r_b, vm4.r_c

        with span("Prove 5" + label):
            ps, pm5 = pr.prove_fifth_round(ps, r_a, r_b, r_c, route)
        fs.feed(pm5.serialize())

        if device_fs:
            with span("Prove Sumcheck 2 (fused)"):
                res2 = fused.sc2_phase(ps.w_cur[None], ps.z_cur[None], [fs.get_state()])[0]
            sc2_msgs = [sc.ProverMsg(evaluations=e) for e in res2.evals]
            fs.set_state(res2.state)
            ps.randomness = res2.rs[:-1]
            last2 = res2.rs[-1]
        else:
            with span("Prove Sumcheck 2" + label):
                sc2_msgs = []
                v_msg = None
                for _ in range(log_n - 1):
                    ps, pm = pr.prove_second_sumcheck_round(ps, v_msg, route)
                    fs.feed(pm.serialize())
                    sc2_msgs.append(pm)
                    v_msg = vr.sample_verify_second_sumcheck_ongoing_round(fs)
                ps, pm = pr.prove_second_sumcheck_round(ps, v_msg, route)
            fs.feed(pm.serialize())
            sc2_msgs.append(pm)
            last2 = vr.sample_verify_second_sumcheck_final_round(fs).last_random_point

        with span("Prove 6" + label):
            pm6 = pr.prove_sixth_round(ps, last2, pp, route)

        return Proof(
            prover_first_message=pm1,
            prover_second_message=pm2,
            prover_third_message=pm3,
            first_sumcheck_messages=sc1_msgs,
            prover_fourth_message=pm4,
            prover_fifth_message=pm5,
            second_sumcheck_messages=sc2_msgs,
            prover_sixth_message=pm6,
        )

    @staticmethod
    def verify(vk: IndexVK, v: List[int], proof: Proof, vp: VerifierParameter) -> bool:
        """True when the proof verifies; a rejected proof raises
        (``InvalidArgument``, ``WrongWitness`` or ``SumCheckError``)."""
        log_n = vk.log_n
        sc1 = list(proof.first_sumcheck_messages)
        sc2 = list(proof.second_sumcheck_messages)
        if len(sc1) != log_n or len(sc2) != log_n:
            raise invalid_arg("malformed sumcheck message")

        fs = _transcript(vk.fs_state, v)
        vs = vr.verifier_init(vk, v)

        fs.feed(proof.prover_first_message.serialize())
        vs, _ = vr.verify_first_round(vs, proof.prover_first_message, fs)
        fs.feed(proof.prover_second_message.serialize())
        vs, _ = vr.verify_second_round(vs, proof.prover_second_message, fs)
        fs.feed(proof.prover_third_message.serialize())
        vs, _ = vr.verify_third_round(vs, proof.prover_third_message)

        for i in range(log_n - 1):
            fs.feed(sc1[i].serialize())
            vs, _ = vr.verify_first_sumcheck_ongoing_round(vs, sc1[i], fs)
        fs.feed(sc1[log_n - 1].serialize())
        vs, _ = vr.verify_first_sumcheck_final_round(vs, sc1[log_n - 1], fs)

        fs.feed(proof.prover_fourth_message.serialize())
        vs, _ = vr.verify_fourth_round(vs, proof.prover_fourth_message, fs)
        fs.feed(proof.prover_fifth_message.serialize())
        vs, _ = vr.verify_fifth_round(vs, proof.prover_fifth_message)

        for i in range(log_n - 1):
            fs.feed(sc2[i].serialize())
            vs, _ = vr.verify_second_sumcheck_ongoing_round(vs, sc2[i], fs)
        fs.feed(sc2[log_n - 1].serialize())
        vs, _ = vr.verify_second_sumcheck_final_round(vs, sc2[log_n - 1], fs)

        fs.feed(proof.prover_sixth_message.serialize())
        with span("Verify 6"):
            return vr.verify_sixth_round(vs, proof.prover_sixth_message, vp)
