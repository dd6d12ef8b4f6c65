"""Proof container: the wire format.

Counterpart of ``spartan_tpu/protocol/proof.py``, byte for byte the same
layout: all six prover messages and both sumcheck message vectors.
Deserialization reads the vectors' length prefixes, so it needs no
instance shape.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

from spartan_tpu_torch.commitment.data_structures import Commitment, OpenProof
from spartan_tpu_torch.protocol import sumcheck as sc
from spartan_tpu_torch.protocol.prover import (
    ProverFifthMessage,
    ProverFirstMessage,
    ProverFourthMessage,
    ProverSecondMessage,
    ProverSixthMessage,
    ProverThirdMessage,
)
from spartan_tpu_torch.utils import serialize as ser
from spartan_tpu_torch.utils.errors import SerializationError


@dataclass
class Proof:
    prover_first_message: ProverFirstMessage
    prover_second_message: ProverSecondMessage
    prover_third_message: ProverThirdMessage
    first_sumcheck_messages: List[sc.ProverMsg]
    prover_fourth_message: ProverFourthMessage
    prover_fifth_message: ProverFifthMessage
    second_sumcheck_messages: List[sc.ProverMsg]
    prover_sixth_message: ProverSixthMessage

    def serialize(self) -> bytes:
        out = [
            self.prover_first_message.serialize(),
            self.prover_second_message.serialize(),
            self.prover_third_message.serialize(),
            ser.ser_u64(len(self.first_sumcheck_messages)),
        ]
        out += [m.serialize() for m in self.first_sumcheck_messages]
        out += [
            self.prover_fourth_message.serialize(),
            self.prover_fifth_message.serialize(),
            ser.ser_u64(len(self.second_sumcheck_messages)),
        ]
        out += [m.serialize() for m in self.second_sumcheck_messages]
        out.append(self.prover_sixth_message.serialize())
        return b"".join(out)

    @classmethod
    def deserialize(cls, data: bytes) -> "Proof":
        off = 0

        def take_u64():
            nonlocal off
            v = int.from_bytes(data[off : off + 8], "little")
            off += 8
            return v

        def take_fr():
            nonlocal off
            v, off2 = ser.deser_fr(data, off)
            off = off2
            return v

        def take_g1():
            nonlocal off
            v, off2 = ser.deser_g1(data, off)
            off = off2
            return v

        def take_g2():
            nonlocal off
            v, off2 = ser.deser_g2(data, off)
            off = off2
            return v

        def take_open_proof():
            h = take_g2()
            npf = take_u64()
            return OpenProof(h=h, proofs=[take_g2() for _ in range(npf)])

        def take_fr_vec():
            n = take_u64()
            return [take_fr() for _ in range(n)]

        def take_index_info():
            return sc.IndexInfo(max_multiplicands=take_u64(), num_variables=take_u64())

        try:
            nv = take_u64()
            pm1 = ProverFirstMessage(Commitment(nv=nv, g_product=take_g1()))
            pm2 = ProverSecondMessage(z_rv_0=take_fr(), proof_for_z_rv_0=take_open_proof())
            pm3 = ProverThirdMessage(ml_index_info=take_index_info())
            sc1 = [sc.ProverMsg(evaluations=take_fr_vec()) for _ in range(take_u64())]
            pm4 = ProverFourthMessage(va=take_fr(), vb=take_fr(), vc=take_fr())
            pm5 = ProverFifthMessage(index_info=take_index_info())
            sc2 = [sc.ProverMsg(evaluations=take_fr_vec()) for _ in range(take_u64())]
            pm6 = ProverSixthMessage(z_ry=take_fr(), proof_for_z_ry=take_open_proof())
        except (IndexError, ValueError) as e:
            raise SerializationError(str(e)) from e
        if off != len(data):
            raise SerializationError("trailing bytes in proof")
        return cls(
            prover_first_message=pm1,
            prover_second_message=pm2,
            prover_third_message=pm3,
            first_sumcheck_messages=sc1,
            prover_fourth_message=pm4,
            prover_fifth_message=pm5,
            second_sumcheck_messages=sc2,
            prover_sixth_message=pm6,
        )
