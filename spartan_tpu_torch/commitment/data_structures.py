"""Polynomial-commitment parameter and proof types.

Counterpart of ``spartan_tpu/commitment/data_structures.py``. The prover's
evaluation hypercubes (``powers_of_g[i]`` in G1, ``powers_of_h[i]`` and the
pairwise-combined ``powers_of_h_comb[i]`` in G2) are affine-encoded
``PointBatch``es on ``device``; generators, verifier masks, commitments and
opening proofs are host affine points, which is all the pairings and the
wire format need.

``pp_from_numpy`` carries a JAX ``PublicParameter`` over: its limb arrays
(16-bit limbs, R = 2^384) repack into the port's 32-bit limbs with the same
R, so both packages compute with the same keys.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import torch

from spartan_tpu_torch.ops import curve as cv
from spartan_tpu_torch.ops.curve import PointBatch
from spartan_tpu_torch.utils import serialize as ser


@dataclass
class PublicParameter:
    nv: int
    powers_of_g: List[PointBatch]  # level i: 2^(nv-i) G1 points
    powers_of_h: List[PointBatch]  # level i: 2^(nv-i) G2 points
    g: tuple  # host affine G1
    h: tuple  # host affine G2
    # comb[i][j] = H_i[2j] + H_i[2j+1]: the opening MSM over combined bases
    # equals the reference's duplicated-scalar MSM at half the points
    powers_of_h_comb: Optional[List[PointBatch]] = None

    @property
    def device(self) -> torch.device:
        return self.powers_of_g[0].device


@dataclass
class VerifierParameter:
    nv: int
    g: tuple  # host affine G1
    h: tuple  # host affine G2
    g_mask_random: List[tuple]  # host affine G1: g^{t_i}


@dataclass(frozen=True)
class Commitment:
    nv: int
    g_product: Optional[tuple]  # host affine G1 (None = infinity)

    def serialize(self) -> bytes:
        return ser.ser_u64(self.nv) + ser.ser_g1(self.g_product)


@dataclass(frozen=True)
class OpenProof:
    h: tuple  # host affine G2
    proofs: List[tuple]  # host affine G2 points

    def serialize(self) -> bytes:
        return ser.ser_g2(self.h) + ser.ser_u64(len(self.proofs)) + b"".join(
            ser.ser_g2(p) for p in self.proofs
        )


def pp_from_numpy(nv: int, powers_of_g, powers_of_h, g, h, powers_of_h_comb=None,
                  device="cpu") -> PublicParameter:
    """The port's ``PublicParameter`` from a JAX one's limb arrays.

    powers_of_g: per level, the (x, y, z) arrays of a JAX G1 ``PointBatch``;
    powers_of_h (and powers_of_h_comb): per level, ((x0, x1), (y0, y1),
    (z0, z1)) of a JAX G2 ``PointBatch``. Arrays are (24, N) uint32 with
    16-bit limbs, as numpy or anything ``numpy.asarray`` takes."""
    if len(powers_of_g) != nv or len(powers_of_h) != nv:
        raise ValueError("one G1 and one G2 table per variable expected")
    return PublicParameter(
        nv=nv,
        powers_of_g=[cv.from_jax(pb, "g1", device) for pb in powers_of_g],
        powers_of_h=[cv.from_jax(pb, "g2", device) for pb in powers_of_h],
        g=g,
        h=h,
        powers_of_h_comb=None if powers_of_h_comb is None else [
            cv.from_jax(pb, "g2", device) for pb in powers_of_h_comb
        ],
    )
