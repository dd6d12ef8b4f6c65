"""Key persistence: save and load a PublicParameter and VerifierParameter.

Counterpart of ``spartan_tpu/commitment/persist.py``, in its ``.npz``
layout, so that either package loads the other's files: one (24, N) uint32
array of 16-bit limbs a coordinate (Montgomery with R = 2^384, the JAX
layout; ``curve.to_jax`` splits the port's 32-bit limbs), named ``g{i}_x``
.. ``g{i}_z`` for the G1 hypercubes, ``h{i}_x0`` .. ``h{i}_z1`` for the G2
ones and ``hc{i}_x0`` .. for the combined opening bases, and a ``meta``
array holding the repr of a dict with ``nv``, ``fmt``, the generators and
the verifier's masks. The hypercubes are a cache, never sent; the small
VerifierParameter has a wire format of compressed points
(``ser_verifier_parameter``).

``fmt`` 2 stores the combined opening bases affine (z = 1); ``fmt`` 1
files stored them Jacobian, so loading one normalizes them once
(``curve.normalize``: K2's ``g2_normalize`` on the card) and rewrites the
file in place.
"""

from __future__ import annotations

import ast

import numpy as np
import torch

from spartan_tpu_torch import kernels
from spartan_tpu_torch.commitment.data_structures import PublicParameter, VerifierParameter, pp_from_numpy
from spartan_tpu_torch.ops import curve as cv
from spartan_tpu_torch.ops.curve import PointBatch
from spartan_tpu_torch.utils import serialize as ser

FMT = 2


def _g2_arrays(prefix: str, pb: PointBatch) -> dict:
    out = {}
    for cname, (c0, c1) in zip("xyz", cv.to_jax(pb)):
        out[f"{prefix}_{cname}0"] = c0
        out[f"{prefix}_{cname}1"] = c1
    return out


def save_keys(path: str, pp: PublicParameter, vp: VerifierParameter) -> None:
    """Write the keys to ``path`` (``numpy.savez``: ``.npz`` is appended
    where it is missing)."""
    arrs = {}
    for i, pb in enumerate(pp.powers_of_g):
        for cname, a in zip("xyz", cv.to_jax(pb)):
            arrs[f"g{i}_{cname}"] = a
    for i, pb in enumerate(pp.powers_of_h):
        arrs.update(_g2_arrays(f"h{i}", pb))
    for i, pb in enumerate(pp.powers_of_h_comb or []):
        arrs.update(_g2_arrays(f"hc{i}", pb))
    meta = {
        "nv": pp.nv,
        "fmt": FMT,
        "g": [pp.g[0], pp.g[1]],
        "h": [[pp.h[0][0], pp.h[0][1]], [pp.h[1][0], pp.h[1][1]]],
        "g_mask": [[p[0], p[1]] for p in vp.g_mask_random],
    }
    arrs["meta"] = np.frombuffer(repr(meta).encode(), dtype=np.uint8)
    np.savez(path, **arrs)


def _g2_leaves(data, prefix: str):
    return tuple((data[f"{prefix}_{c}0"], data[f"{prefix}_{c}1"]) for c in "xyz")


def load_keys(path: str, device="cuda"):
    """(pp, vp) from a file of either package, pp's tables on ``device``
    (the card unless the caller names another)."""
    device = kernels.require_device(device)
    data = np.load(path)
    meta = ast.literal_eval(bytes(data["meta"]).decode())
    nv = meta["nv"]
    comb = None
    if all(f"hc{i}_x0" in data for i in range(nv)):
        comb = [_g2_leaves(data, f"hc{i}") for i in range(nv)]
    g = tuple(meta["g"])
    h = (tuple(meta["h"][0]), tuple(meta["h"][1]))
    pp = pp_from_numpy(
        nv,
        powers_of_g=[tuple(data[f"g{i}_{c}"] for c in "xyz") for i in range(nv)],
        powers_of_h=[_g2_leaves(data, f"h{i}") for i in range(nv)],
        g=g, h=h, powers_of_h_comb=comb, device=device,
    )
    vp = VerifierParameter(nv=nv, g=g, h=h, g_mask_random=[tuple(p) for p in meta["g_mask"]])
    if comb is not None and meta.get("fmt", 1) < FMT:
        sizes = [pb.n for pb in pp.powers_of_h_comb]
        cat = cv.normalize(PointBatch.cat(pp.powers_of_h_comb))
        pp.powers_of_h_comb = [PointBatch(d.contiguous(), "g2") for d in torch.split(cat.data, sizes, dim=2)]
        try:  # rewrite the file so that the normalization is paid once
            save_keys(path, pp, vp)
        except OSError:
            pass
    return pp, vp


def ser_verifier_parameter(vp: VerifierParameter) -> bytes:
    """Canonical wire bytes of the verifier parameter."""
    out = [ser.ser_u64(vp.nv), ser.ser_g1(vp.g), ser.ser_g2(vp.h), ser.ser_u64(len(vp.g_mask_random))]
    out += [ser.ser_g1(p) for p in vp.g_mask_random]
    return b"".join(out)


def deser_verifier_parameter(data: bytes) -> VerifierParameter:
    off = 0
    nv = int.from_bytes(data[off : off + 8], "little")
    off += 8
    g, off = ser.deser_g1(data, off)
    h, off = ser.deser_g2(data, off)
    n = int.from_bytes(data[off : off + 8], "little")
    off += 8
    masks = []
    for _ in range(n):
        p, off = ser.deser_g1(data, off)
        masks.append(p)
    return VerifierParameter(nv=nv, g=g, h=h, g_mask_random=masks)
