"""The sumcheck phases with the transcript on the device.

Counterpart of ``spartan_tpu/protocol/fused.py`` (``sc1_phase`` :236,
``sc2_phase`` :284, the emit steps :111/:137/:154). The host-transcript
route decodes every round's evaluations before it samples the next
challenge: one sync a round. Here the transcript runs on the device: a
round is one launch of a round kernel (K6 or K7, ``ops/sumcheck``) and one
of a transcript kernel (K5, ``csrc/fs_ops.cu``), which adds the round
kernel's partials, extends them to the wire's evaluations, absorbs them
with Blake2s and samples the next challenge into device memory. The loop
over the rounds never reads a device value. One upload starts a phase and
one copy to the host ends it: the messages, the challenges, round 4's
va, vb, vc and r_a, r_b, r_c, and the chain state, from which the host
transcript resumes. The proof bytes equal the host route's.

The JAX package's ``TAIL_W`` padding and ``lax.scan`` tail programs, which
exist for XLA's compile cost, stay behind: a phase is a Python loop over
its log_n rounds.

On CPU tensors every step is its plain PyTorch version (``sc1_emit_plain``
and the others below, ``ops/sumcheck``'s ``PLAIN`` rounds); on CUDA tensors
the wrappers launch the kernels or raise.
"""

from __future__ import annotations

from functools import partial
from typing import List, NamedTuple

import numpy as np
import torch

from spartan_tpu_torch import kernels
from spartan_tpu_torch.host import field as hf
from spartan_tpu_torch.ops import field as fo
from spartan_tpu_torch.ops import fs_device as fsd
from spartan_tpu_torch.ops import sumcheck as sck
from spartan_tpu_torch.ops.field import FR

W = FR.nlimb  # words of an element: its canonical limbs are its serialization


# ---------------------------------------------------------------------------
# Constants and buffers
# ---------------------------------------------------------------------------

_EMIT_CONSTS: dict = {}


def emit_consts(deg: int, device) -> torch.Tensor:
    """The Montgomery rows of a sumcheck-1 emit step, (5, deg + 1, 8): at
    t = 0..deg the Lagrange coefficients through (0, q0), (1, q1), (2, q2),

        c0(t) = (t - 1)(t - 2) / 2,  c1(t) = -t (t - 2),  c2(t) = t (t - 1) / 2,

    and the pieces of the eq factor l_i(t) = tor_i ea(t) + eb(t),
    ea(t) = 2t - 1 and eb(t) = 1 - t. Cached by degree and device."""
    key = (deg, str(device))
    out = _EMIT_CONSTS.get(key)
    if out is None:
        r, inv2 = hf.R, pow(2, -1, hf.R)
        ts = range(deg + 1)
        rows = ([(t - 1) * (t - 2) % r * inv2 % r for t in ts] + [-t * (t - 2) % r for t in ts]
                + [t * (t - 1) % r * inv2 % r for t in ts] + [(2 * t - 1) % r for t in ts]
                + [(1 - t) % r for t in ts])
        limbs = fo.encode_mont(FR, rows).t().reshape(5, deg + 1, W).contiguous()
        out = _upload(limbs.numpy(), torch.device(device))
        _EMIT_CONSTS[key] = out
    return out


def _upload(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array to ``device`` without waiting for it: a pinned copy and
    an asynchronous transfer on the current stream."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type == "cpu":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def _words(ints) -> np.ndarray:
    """Canonical field ints -> (n, 8) int32 words (each row an element)."""
    return fo.ints_to_limbs(list(ints), W).T


def _ints(words: np.ndarray) -> List[int]:
    """(..., 8) int32 words -> the ints of the rows."""
    rows = np.ascontiguousarray(words.reshape(-1, W)).view(np.uint32)
    return [int.from_bytes(row.astype("<u4").tobytes(), "little") for row in rows]


class _Buffer:
    """One int32 buffer for a phase, cut into named (count, 8) element
    arrays: uploaded once at the start, copied to the host once at the end."""

    def __init__(self, parts):
        self.offsets, n = {}, 0
        for name, count in parts:
            self.offsets[name] = (n, count)
            n += count * W
        self.host = np.zeros(n, dtype=np.int32)

    def set(self, name: str, words: np.ndarray) -> None:
        off, count = self.offsets[name]
        self.host[off : off + count * W] = words.reshape(-1)

    def upload(self, device: torch.device) -> None:
        self.dev = _upload(self.host, device)

    def view(self, name: str) -> torch.Tensor:
        off, count = self.offsets[name]
        return self.dev[off : off + count * W].view(count, W)

    def fetch(self) -> None:
        """The phase's one copy from the device to the host."""
        self.host = self.dev.cpu().numpy()

    def get(self, name: str) -> np.ndarray:
        off, count = self.offsets[name]
        return self.host[off : off + count * W].reshape(count, W)


# ---------------------------------------------------------------------------
# The transcript kernels (K5) and their plain versions
# ---------------------------------------------------------------------------

_m = partial(fo.mont_mul_plain, FR)


def _mul(a, b):
    return _m(*torch.broadcast_tensors(a, b))


def _add(a, b):
    return fo.add_plain(FR, *torch.broadcast_tensors(a, b))


def _sub(a, b):
    return fo.sub_plain(FR, *torch.broadcast_tensors(a, b))


def _col(t: torch.Tensor) -> torch.Tensor:
    """An element stored as 8 words -> an (8, 1) limb column."""
    return t.reshape(W, 1)


def _const_col(x: int, device) -> torch.Tensor:
    return fo.encode_ints(FR, [x], device)


def _absorb_sample_plain(state, msg_words, r_out, r_mont):
    """Absorb ``msg_words`` (the words after the chain state), sample the
    challenge from block 0 of the new stream, write it to r_out (canonical)
    and r_mont and the new chain state to state. Returns r Montgomery (8, 1)."""
    st = fsd.fs_feed(fsd.as_words(state.reshape(-1)), msg_words)
    r, _ctr = fsd.fs_sample_fr(st, 0)
    rc = _col(fsd.as_int32(r))
    rm = _mul(rc, _const_col(FR.r_mod * FR.r_mod % FR.modulus, rc.device))
    r_out.copy_(rc.reshape(r_out.shape))
    r_mont.copy_(rm.reshape(r_mont.shape))
    state.copy_(fsd.as_int32(st).reshape(state.shape))
    return rm


def _q_plain(partials: torch.Tensor) -> torch.Tensor:
    """(3, B, 8) partials -> their sums (8, 3), Montgomery."""
    return fo.sum_mod(partials.permute(2, 0, 1))[..., 0]


def _from_mont(x: torch.Tensor) -> torch.Tensor:
    return _mul(x, _const_col(1, x.device))


def sc1_emit_plain(partials, tor_i, consts, pre, state, evals, r_out, r_mont) -> None:
    """``fs_sc1_emit`` in PyTorch: extend q(0), q(1), q(2) (the sums of the
    partials) to the wire's evaluations pre l_i(t) q(t) at t = 0..D-1, write
    them canonical to evals (D, 8), absorb ser_fr_vec of them, sample r_i;
    pre becomes pre l_i(r_i). Writes evals, r_out, r_mont, pre and state."""
    q = _q_plain(partials)
    c = consts.permute(2, 0, 1)  # (8, 5, D)
    qt = _add(_mul(q[:, 0:1], c[:, 0]), _add(_mul(q[:, 1:2], c[:, 1]), _mul(q[:, 2:3], c[:, 2])))
    tor, p = _col(tor_i), _col(pre)
    ell = _add(_mul(tor, c[:, 3]), c[:, 4])
    ev = _from_mont(_mul(p, _mul(ell, qt)))  # (8, D) canonical
    evals.copy_(ev.t())
    rm = _absorb_sample_plain(state, fsd.ser_fr_vec_words(ev), r_out, r_mont)
    t2 = _mul(tor, rm)  # l_i(r) = 2 tor_i r - tor_i - r + 1
    ell_r = _add(_sub(_sub(_add(t2, t2), tor), rm), _const_col(FR.r_mod, rm.device))
    pre.copy_(_mul(p, ell_r).reshape(pre.shape))


def sc1_final_plain(az, bz, cz, r_mont, state, vabc, rabc) -> None:
    """``fs_sc1_final`` in PyTorch: round 4. Fold the width-2 tables by the
    last challenge, write va, vb, vc canonical to vabc (3, 8), absorb them
    (no prefix), sample r_a, r_b, r_c on one counter into rabc (3, 8)."""
    r = _col(r_mont)
    abc = torch.cat([az, bz, cz], dim=1)  # (8, 6)
    v = _from_mont(_add(abc[:, 0::2], _mul(_sub(abc[:, 1::2], abc[:, 0::2]), r)))  # (8, 3)
    vabc.copy_(v.t())
    st = fsd.fs_feed(fsd.as_words(state.reshape(-1)), fsd.limbs_to_words(v).reshape(-1))
    ctr = 0
    for k in range(3):
        rk, ctr = fsd.fs_sample_fr(st, ctr)
        rabc[k].copy_(fsd.as_int32(rk))
    state.copy_(fsd.as_int32(st).reshape(state.shape))


def sc2_emit_plain(partials, state, evals, r_out, r_mont) -> None:
    """``fs_sc2_emit`` in PyTorch: the three evaluations canonical to evals
    (3, 8), absorbed with their prefix; sample r."""
    ev = _from_mont(_q_plain(partials))  # (8, 3)
    evals.copy_(ev.t())
    _absorb_sample_plain(state, fsd.ser_fr_vec_words(ev), r_out, r_mont)


def sc1_emit(partials, tor_i, consts, pre, state, evals, r_out, r_mont) -> None:
    """K5 ``fs_sc1_emit`` on CUDA tensors; ``sc1_emit_plain`` on CPU ones."""
    if partials.device.type == "cpu":
        return sc1_emit_plain(partials, tor_i, consts, pre, state, evals, r_out, r_mont)
    nblocks, d = partials.shape[1], consts.shape[1]
    kernels.call("fs_sc1_emit", [partials, tor_i, consts, pre, state, evals, r_out, r_mont],
                 [nblocks, d], key=(nblocks, d))


def sc1_final(az, bz, cz, r_mont, state, vabc, rabc) -> None:
    """K5 ``fs_sc1_final`` on CUDA tensors; ``sc1_final_plain`` on CPU ones."""
    if az.shape[-1] != 2:
        raise ValueError(f"round 4 folds width-2 tables, got width {az.shape[-1]}")
    if az.device.type == "cpu":
        return sc1_final_plain(az, bz, cz, r_mont, state, vabc, rabc)
    kernels.call("fs_sc1_final", [az.contiguous(), bz.contiguous(), cz.contiguous(), r_mont, state,
                                  vabc, rabc], [], key=(2,))


def sc2_emit(partials, state, evals, r_out, r_mont) -> None:
    """K5 ``fs_sc2_emit`` on CUDA tensors; ``sc2_emit_plain`` on CPU ones."""
    if partials.device.type == "cpu":
        return sc2_emit_plain(partials, state, evals, r_out, r_mont)
    kernels.call("fs_sc2_emit", [partials, state, evals, r_out, r_mont], [partials.shape[1]],
                 key=(partials.shape[1],))


# ---------------------------------------------------------------------------
# The phases
# ---------------------------------------------------------------------------


class Sc1Result(NamedTuple):
    evals: List[List[int]]  # the log_n messages, log_n + 3 evaluations each
    rs: List[int]  # r_1..r_{log_n - 1}, then the last random point
    vabc: List[int]  # round 4's va, vb, vc
    rabc: List[int]  # r_a, r_b, r_c
    state: bytes  # the chain state after r_c


class Sc2Result(NamedTuple):
    evals: List[List[int]]  # the log_n messages, 3 evaluations each
    rs: List[int]
    state: bytes


def sc1_phase(az, bz, cz, suffix, tor: List[int], state: bytes) -> Sc1Result:
    """Sumcheck 1 and prover round 4 with the transcript on the device.

    az, bz, cz: (8, n) Montgomery tables; suffix: the eq suffix tables of
    tor (``mle.eq_suffix_tables``); tor: the log_n challenges as ints;
    state: the chain state after the third prover message."""
    log_n = len(tor)
    d = log_n + 3
    buf = _Buffer([("evals", log_n * d), ("rs", log_n), ("vabc", 3), ("rabc", 3), ("state", 1),
                   ("pre", 1), ("r_mont", 1), ("tor", log_n)])
    buf.set("state", fsd.as_int32(fsd.state_to_words(state)).numpy())
    buf.set("pre", _words([FR.r_mod]))  # 1 in Montgomery form
    buf.set("tor", _words([t * FR.r_mod % FR.modulus for t in tor]))
    dev = az.device
    buf.upload(dev)
    consts = emit_consts(log_n + 2, dev)
    evals, rs, tor_m = buf.view("evals").view(log_n, d, W), buf.view("rs"), buf.view("tor")
    pre, st, r_mont = buf.view("pre"), buf.view("state"), buf.view("r_mont")
    for i in range(log_n):  # round 0 takes no fold: r_mont is not read
        partials, az, bz, cz = sck.sc1_round_dev(az, bz, cz, suffix[i + 1], i > 0, r_mont)
        sc1_emit(partials, tor_m[i], consts, pre, st, evals[i], rs[i], r_mont)
    sc1_final(az, bz, cz, r_mont, st, buf.view("vabc"), buf.view("rabc"))
    buf.fetch()
    ev = _ints(buf.get("evals"))
    return Sc1Result(evals=[ev[i * d : (i + 1) * d] for i in range(log_n)], rs=_ints(buf.get("rs")),
                     vabc=_ints(buf.get("vabc")), rabc=_ints(buf.get("rabc")),
                     state=fsd.words_to_state(buf.get("state")))


def sc2_phase(w, z, state: bytes) -> Sc2Result:
    """Sumcheck 2 with the transcript on the device. w, z: (8, n) Montgomery
    tables; state: the chain state after the fifth prover message."""
    log_n = w.shape[-1].bit_length() - 1
    buf = _Buffer([("evals", 3 * log_n), ("rs", log_n), ("state", 1), ("r_mont", 1)])
    buf.set("state", fsd.as_int32(fsd.state_to_words(state)).numpy())
    buf.upload(w.device)
    evals, rs = buf.view("evals").view(log_n, 3, W), buf.view("rs")
    st, r_mont = buf.view("state"), buf.view("r_mont")
    for i in range(log_n):
        partials, w, z = sck.prod2_round_dev(w, z, i > 0, r_mont)
        sc2_emit(partials, st, evals[i], rs[i], r_mont)
    buf.fetch()
    ev = _ints(buf.get("evals"))
    return Sc2Result(evals=[ev[3 * i : 3 * (i + 1)] for i in range(log_n)], rs=_ints(buf.get("rs")),
                     state=fsd.words_to_state(buf.get("state")))
