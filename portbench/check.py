"""The comparison that decides ``correct``: the program's proofs and keys
against the plain reference (``reference/spartan.py``), exact, field by
field.

Three numbers, each with the limit 0, since the proof is deterministic and
any difference is a different proof:

- ``keys_differing``: of a sample of the program's commitment keys (a few
  entries of every level of the G1, G2 and combined G2 tables, drawn from
  the seed, and g, h and the verifier's g^{t_i}), those that are not the
  reference's point;
- ``commitments_differing``: of every proof the window produced, those
  whose first message (the witness commitment) is not the reference's for
  its instance;
- ``fields_differing``: of a sample of the window's proofs drawn from the
  seed, the fields (each message, each sumcheck evaluation, each opening's
  evaluation and G2 point) that are not the reference's. The sample holds
  one proof of every slot position of a call (a call of ``prove_many`` on
  B instances has B; a call of ``prove`` one), each from a call drawn from
  the seed, and ``CHECK_IN_FULL`` more proofs drawn from the seed, so a
  fault confined to one slot of the batch cannot slip past.

The reference proves the sampled instances in ``workers()`` processes,
forked after the window has closed and the program's state has been freed.
"""

from __future__ import annotations

import multiprocessing
import os
import random
import warnings
from typing import Callable, Dict, List

import numpy as np

from portbench.reference.curve import P, R
from portbench.reference.spartan import Reference, fields_differing
from portbench.reference.transcript import u64

_FP_RINV = pow(1 << 384, -1, P)
KEYS_PER_LEVEL = 2
CHECK_IN_FULL = 4
WORKERS = 8


def _fp(limbs) -> int:
    """12 32-bit limbs, least significant first, of a Montgomery Fp value."""
    x = int.from_bytes(np.asarray(limbs, dtype=np.int32).view(np.uint32).astype("<u4").tobytes(), "little")
    return x * _FP_RINV % P


def _point(col, group: str):
    """An affine-encoded point of the program's tables, (coords, 12) limbs,
    as an affine tuple; None for infinity (z = 0)."""
    c = [_fp(col[k]) for k in range(col.shape[0])]
    if group == "g1":
        return None if c[2] == 0 else (c[0], c[1])
    return None if c[4] == 0 and c[5] == 0 else ((c[0], c[1]), (c[2], c[3]))


def sample_keys(pp, vp, nv: int, rng: random.Random) -> List[tuple]:
    """(name, level, entry, the program's point) for a sample of the keys,
    read from the program's tables: done while they are on the device."""
    out = [("g", -1, 0, pp.g), ("h", -1, 0, pp.h)]
    out += [("g_mask", i, 0, p) for i, p in enumerate(vp.g_mask_random)]
    tables = (("g1", pp.powers_of_g, "g1"), ("g2", pp.powers_of_h, "g2"), ("g2_comb", pp.powers_of_h_comb, "g2"))
    for level in range(nv):
        for name, levels, group in tables:
            data = levels[level].data
            for _ in range(KEYS_PER_LEVEL):
                j = rng.randrange(data.shape[-1])
                out.append((name, level, j, _point(data[:, :, j].cpu().numpy(), group)))
    return out


def keys_differing(ref: Reference, sampled: List[tuple]) -> List[str]:
    keys = ref.keys
    want = {
        "g": lambda i, j: keys.g, "h": lambda i, j: keys.h, "g_mask": lambda i, j: keys.g_mask(i),
        "g1": keys.g1_key, "g2": keys.g2_key, "g2_comb": keys.g2_comb_key,
    }
    return [f"{name}[{level}][{j}]" for name, level, j, got in sampled if want[name](level, j) != got]


def workers() -> int:
    """Processes for the reference: the cores this process may use, at most
    ``WORKERS``."""
    return max(1, min(WORKERS, len(os.sched_getaffinity(0))))


_TASK: List[Callable] = []  # the function a forked worker applies


def _apply(item):
    return _TASK[0](item)


def parallel_map(fn: Callable, items: list) -> list:
    """[fn(x) for x in items] in ``workers()`` forked processes (in this one
    where that is 1); the workers inherit fn and what it reads, and are
    joined before this returns."""
    n = workers()
    if n <= 1 or len(items) <= 1:
        return [fn(x) for x in items]
    _TASK[:] = [fn]
    with warnings.catch_warnings():  # the workers touch neither the card nor torch's threads
        warnings.simplefilter("ignore", DeprecationWarning)
        pool = multiprocessing.get_context("fork").Pool(min(n, len(items)))
    try:
        return pool.map(_apply, items, chunksize=1)
    finally:
        pool.close()
        pool.join()
        _TASK.clear()


def full_picks(n_proofs: int, batch: int, rng: random.Random) -> List[int]:
    """Indices of the proofs checked in full: for every slot position of a
    call one proof, from a call drawn from ``rng``, and ``CHECK_IN_FULL``
    more drawn from ``rng``. The window's proofs come call by call, ``batch``
    to a call."""
    calls = n_proofs // batch
    picks = {rng.randrange(calls) * batch + slot for slot in range(batch)} if calls else set()
    rest = [k for k in range(n_proofs) if k not in picks]
    return sorted(picks | set(rng.sample(rest, min(CHECK_IN_FULL, len(rest)))))


def check_run(ref: Reference, instances: Dict[int, tuple], proofs: List[tuple], batch: int,
              rng: random.Random, sampled_keys: List[tuple]) -> dict:
    """``proofs``: (instance id, the program's proof bytes) of every proof
    of the window, ``batch`` to a call. Checks the keys, every proof's
    commitment, and the proofs of ``full_picks`` in full."""
    bad_keys = keys_differing(ref, sampled_keys)
    first = {}  # instance id -> the reference's first message
    bad_commit = []
    for k, (inst, got) in enumerate(proofs):
        if inst not in first:
            v, w = instances[inst]
            z = np.empty(len(v) + len(w), dtype=object)
            z[:] = [x % R for x in list(v) + list(w)]
            first[inst] = u64(ref.log_n) + ref.commitment(z)
        if got[: len(first[inst])] != first[inst]:
            bad_commit.append(k)
    picks = full_picks(len(proofs), batch, rng)
    names = parallel_map(lambda k: fields_differing(ref.prove(*instances[proofs[k][0]]), proofs[k][1]), picks)
    bad_fields, failed = [], set(bad_commit)
    for k, differ in zip(picks, names):
        if differ:
            failed.add(k)
        bad_fields += [f"proof {k}: {n}" for n in differ]
    return {
        "keys_differing": bad_keys,
        "commitments_differing": bad_commit,
        "fields_differing": bad_fields,
        "proofs_checked": len(picks),
        "failed": len(failed),
    }
