"""Sharded prover kernels: hypercube-partitioned sumcheck rounds and
point-range MSMs over a mesh of devices, driven from one process.

Counterpart of ``spartan_tpu/parallel/sharded.py``, which runs the same
partitions under ``shard_map``:

- **Tables** are split over the evaluation (hypercube) axis by high-order
  index bits: an (8, N) table becomes D contiguous (8, N / D) blocks, block
  k on device k. The protocol folds variable 0 (the least significant bit),
  so a fold pairs adjacent entries of one block: folds stay local and the
  only cross-shard traffic of a round is its D (8, 3) partial sums, added
  mod r on the mesh's first device (the JAX version's psum).
- **MSMs** are split by point range: each shard runs the local Pippenger
  (``ops/msm.py``) with 8-bit windows, then its partial point is copied to
  the first device and the D partials are tree-reduced there (the JAX
  version's all-gather). Shards that share a device run as one
  ``msm_many`` of as many problems, so D shards on one card cost one pass.

Every shard's work goes through the kernels of its device: K1 in the
rounds, K3 (G1) or K4 (G2) in the MSMs and the reduction. A mesh may name
one device several times (``make_mesh(devices=["cuda:0"] * 4)``, or
``["cpu"] * 4`` for the plain versions): every sharded code path runs all
the same.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch

from spartan_tpu_torch import kernels
from spartan_tpu_torch.ops import curve as cv
from spartan_tpu_torch.ops import field as fo
from spartan_tpu_torch.ops import msm as msm_mod
from spartan_tpu_torch.ops import sumcheck as sck
from spartan_tpu_torch.ops.curve import PointBatch
from spartan_tpu_torch.utils.errors import invalid_arg

MSM_WINDOW = 8  # the sharded MSM's window width, as spartan_tpu/parallel/sharded.py:192 fixes it


@dataclass(frozen=True)
class Mesh:
    """An ordered tuple of devices; shard k lives on ``devices[k]``."""

    devices: Tuple[torch.device, ...]

    def __len__(self) -> int:
        return len(self.devices)

    @property
    def first(self) -> torch.device:
        """Where partial sums and points are reduced and unsharded work runs."""
        return self.devices[0]


def _indexed(dev: torch.device) -> torch.device:
    """``cuda`` as ``cuda:<current>``, as a tensor placed there reports it."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(n_devices: Optional[int] = None, devices: Optional[Sequence] = None) -> Mesh:
    """A mesh over the first ``n_devices`` CUDA devices (all of them by
    default), or over the ``devices`` named, in order.

    There is no fallback: asking for more CUDA devices than exist raises.
    D shards on one card, or on the CPU, are asked for by name:
    ``make_mesh(devices=["cuda:0"] * 4)``, ``make_mesh(devices=["cpu"] * 4)``."""
    if devices is not None:
        devs = tuple(_indexed(kernels.require_device(d)) for d in devices)
        if n_devices is not None and n_devices != len(devs):
            raise ValueError(f"{n_devices} devices asked for, {len(devs)} named")
    else:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        n = have if n_devices is None else n_devices
        if n > have or n < 1:
            raise RuntimeError(
                f"a {n_devices}-device mesh asked for, but {have} CUDA devices exist; name the "
                "devices to place several shards on one (make_mesh(devices=['cuda:0'] * 4)) or on "
                "the CPU (devices=['cpu'] * 4)")
        devs = tuple(torch.device("cuda", i) for i in range(n))
    if not devs:
        raise ValueError("a mesh needs at least one device")
    return Mesh(devs)


def shard_table(mesh: Mesh, table: torch.Tensor) -> List[torch.Tensor]:
    """D contiguous blocks of the last axis, block k on device k: a view
    where the block's device is the table's, a copy otherwise."""
    d = len(mesh)
    n = table.shape[-1]
    if n % d:
        raise invalid_arg(f"{n} entries do not split over {d} shards")
    m = n // d
    return [table[..., k * m : (k + 1) * m].to(dev) for k, dev in enumerate(mesh.devices)]


def shard_points(mesh: Mesh, points: PointBatch) -> List[PointBatch]:
    """The point-range split of a batch, as ``shard_table``."""
    return [PointBatch(s, points.group) for s in shard_table(mesh, points.data)]


def gather(mesh: Mesh, shards: List[torch.Tensor]) -> torch.Tensor:
    """The shards in shard order as one table on the first device."""
    return torch.cat([s.to(mesh.first) for s in shards], dim=-1)


def _psum(mesh: Mesh, parts: List[torch.Tensor]) -> torch.Tensor:
    """sum_k parts[k] mod r on the first device: (8, 3) canonical."""
    stacked = torch.stack([p.to(mesh.first) for p in parts], dim=-1)  # (8, 3, D)
    return fo.sum_mod(stacked)[..., 0]


# ---------------------------------------------------------------------------
# Sharded sumcheck rounds
# ---------------------------------------------------------------------------


def sc1_round(mesh: Mesh, az, bz, cz, s_table: torch.Tensor, do_fold: bool, r: torch.Tensor = None):
    """One sumcheck-1 round over sharded tables (``sharded.py:82-144``):
    each shard folds by r (when ``do_fold``) and evaluates its part of the
    inner quadratic with ``ops/sumcheck.py:sc1_round``; ``s_table``, the
    round's eq suffix table, is split the same way. Returns ((8, 3) evals on
    the first device, az', bz', cz' as shard lists)."""
    s = shard_table(mesh, s_table)
    parts, out = [], ([], [], [])
    for k, dev in enumerate(mesh.devices):
        ev, *tabs = sck.sc1_round(az[k], bz[k], cz[k], s[k], do_fold, r.to(dev) if do_fold else None)
        parts.append(ev)
        for lst, t in zip(out, tabs):
            lst.append(t)
    return (_psum(mesh, parts), *out)


def prod2_round(mesh: Mesh, w, z, do_fold: bool, r: torch.Tensor = None):
    """One degree-2 round over sharded tables (``sharded.py:147-189``) on
    ``ops/sumcheck.py:prod2_round``. Returns ((8, 3) evals, w', z')."""
    parts, ws, zs = [], [], []
    for k, dev in enumerate(mesh.devices):
        ev, wk, zk = sck.prod2_round(w[k], z[k], do_fold, r.to(dev) if do_fold else None)
        parts.append(ev)
        ws.append(wk)
        zs.append(zk)
    return _psum(mesh, parts), ws, zs


# ---------------------------------------------------------------------------
# Sharded MSM
# ---------------------------------------------------------------------------


def tree_reduce(parts: PointBatch) -> PointBatch:
    """The sum of a batch's D points by repeated halving, the odd lane
    added into the first (``sharded.py:211-233``). One point."""
    acc = parts
    d = acc.n
    while d > 1:
        half = d // 2
        summed = cv.add(acc.take(slice(0, half)), acc.take(slice(half, 2 * half)))
        if d % 2:
            patched = cv.add(summed.take(slice(0, 1)), acc.take(slice(d - 1, d)))
            summed = PointBatch.cat([patched, summed.take(slice(1, None))])
        acc = summed
        d = half
    return acc


def msm(mesh: Mesh, points: List[PointBatch], scalars: List[torch.Tensor], c: int = MSM_WINDOW) -> PointBatch:
    """Point-range MSM (``sharded.py:192-235``): points and scalars as
    shard lists (affine-encoded bases, canonical Fr limbs). Each shard's
    local MSM runs on its device, the shards of one device as one
    ``msm_many``; the D partial points are copied to the first device in
    shard order and tree-reduced. Returns one Jacobian point there."""
    if len(points) != len(mesh) or len(scalars) != len(mesh):
        raise invalid_arg("one point shard and one scalar shard per device expected")
    by_dev: dict = {}
    for k, dev in enumerate(mesh.devices):
        by_dev.setdefault(dev, []).append(k)
    partial = [None] * len(mesh)
    for ks in by_dev.values():
        res = msm_mod.msm_many(PointBatch.cat([points[k] for k in ks]), [points[k].n for k in ks],
                               torch.cat([scalars[k] for k in ks], dim=1), c)
        for j, k in enumerate(ks):
            partial[k] = PointBatch(res.data[..., j : j + 1].to(mesh.first), res.group)
    return tree_reduce(PointBatch.cat(partial))
