"""The sumcheck phases with the transcript on the device.

Counterpart of ``spartan_tpu/protocol/fused.py`` (``sc1_phase`` :236,
``sc2_phase`` :284, the emit steps :111/:137/:154, the tail programs
:166/:205). The host-transcript route decodes every round's evaluations
before it samples the next challenge: one sync a round. Here a round is one
launch (``csrc/sumcheck.cuh``): the round kernel (K6 or K7) folds and
evaluates, and the block that finishes last runs the round's transcript
step (K5): it adds the blocks' partial sums, extends them to the wire's
evaluations, absorbs them with Blake2s and samples the next challenge into
device memory. From the first round of at most ``TAIL_PAIRS`` pairs one
launch, the tail, runs every remaining round in one block (and, for
sumcheck 1, prover round 4). The loop over the rounds never reads a device
value. One upload starts a phase and one copy to the host ends it: the
messages, the challenges, round 4's va, vb, vc and r_a, r_b, r_c, and the
chain state, from which the host transcript resumes. The proof bytes equal
the host route's.

The JAX package's ``TAIL_W`` padding, which exists for XLA's compile cost,
stays behind; its tail programs became the one-block tails.

Every launch and both phases run B instances of one circuit (also the
counterparts of ``spartan_tpu/protocol/batched.py``'s ``sc1_phase_b`` :328
and ``sc2_phase_b`` :408): each round one launch for the whole batch, each
tail one block an instance, one upload and one copy back for the batch.
The single prove is B = 1.

On CPU tensors every launch is its plain PyTorch version
(``sc1_round_plain`` and the others below, over ``ops/sumcheck``'s
``PLAIN`` rounds, on each instance); on CUDA tensors the wrappers launch
the kernels or raise.
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
    """The Montgomery rows of a sumcheck-1 transcript step, (5, deg + 1, 8):
    at t = 0..deg the Lagrange coefficients through (0, q0), (1, q1), (2, q2),

        c0(t) = (t - 1)(t - 2) / 2,  c1(t) = -t (t - 2),  c2(t) = t (t - 1) / 2,

    and the pieces of the eq factor l_i(t) = tor_i ea(t) + eb(t),
    ea(t) = 2t - 1 and eb(t) = 1 - t. Cached by degree and device."""
    key = (deg, str(device))
    out = _EMIT_CONSTS.get(key)
    if out is None:
        limbs = fo.encode_mont(FR, [x for row in _step_rows(deg) for x in row])
        limbs = limbs.t().reshape(5, deg + 1, W).contiguous()
        out = _upload(limbs.numpy(), torch.device(device))
        _EMIT_CONSTS[key] = out
    return out


def _step_rows(deg: int) -> List[List[int]]:
    """c0, c1, c2, ea, eb at t = 0..deg, as ints."""
    r, inv2 = hf.R, pow(2, -1, hf.R)
    ts = range(deg + 1)
    return [[(t - 1) * (t - 2) % r * inv2 % r for t in ts], [-t * (t - 2) % r for t in ts],
            [t * (t - 1) % r * inv2 % r for t in ts], [(2 * t - 1) % r for t in ts], [(1 - t) % r for t in ts]]


def first_coef(tor0: int, deg: int) -> List[int]:
    """Round 0's transcript-step coefficients (pre = 1) as ints, the rows of
    ``coef`` (6, deg + 1, 8): K_k(t) = c_k(t) l_0(t) and K_k(t) R, with
    l_0(t) = tor_0 ea(t) + eb(t)."""
    c0, c1, c2, ea, eb = _step_rows(deg)
    ell = [(tor0 * a + b) % hf.R for a, b in zip(ea, eb)]
    k = [c * e % hf.R for row in (c0, c1, c2) for c, e in zip(row, ell)]
    return k + [x * FR.r_mod % hf.R for x in k]


def _upload(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array to ``device`` without waiting for it: a pinned copy and
    an asynchronous transfer on the current stream."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type == "cpu":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def _words(ints) -> np.ndarray:
    """Canonical field ints -> (n, 8) int32 words (each row an element)."""
    return np.ascontiguousarray(fo.ints_to_limbs(list(ints), W).T)


def _ints(words: np.ndarray) -> List[int]:
    """(..., 8) int32 words -> the ints of the rows."""
    rows = np.ascontiguousarray(words.reshape(-1, W)).view(np.uint32)
    return [int.from_bytes(row.astype("<u4").tobytes(), "little") for row in rows]


class _Buffer:
    """One int32 buffer for a phase, cut into named (count, 8) element
    arrays: uploaded once at the start, copied to the host once at the end.
    With ``copies`` > 1, one copy of that layout an instance, one after the
    other (the batch axis): ``size`` words apart."""

    def __init__(self, parts, copies: int = 1):
        self.offsets, n = {}, 0
        for name, count in parts:
            self.offsets[name] = (n, count)
            n += count * W
        self.copies, self.size = copies, n
        self.host = np.zeros((copies, n), dtype=np.int32)

    def set(self, name: str, words: np.ndarray) -> None:
        """Words for every copy: (count, 8) for all alike, or one such
        array a copy."""
        off, count = self.offsets[name]
        self.host[:, off : off + count * W] = np.asarray(words).reshape(-1, count * W)

    def upload(self, device: torch.device) -> None:
        self.dev = _upload(self.host.reshape(-1), device)

    def views(self, name: str) -> torch.Tensor:
        """Every copy's array, (copies, count, 8), ``size`` words apart."""
        off, count = self.offsets[name]
        return self.dev.view(self.copies, self.size)[:, off : off + count * W].view(self.copies, count, W)

    def fetch(self) -> None:
        """The phase's one copy from the device to the host."""
        self.host = self.dev.cpu().numpy().reshape(self.copies, self.size)

    def get(self, name: str, copy: int = 0) -> np.ndarray:
        off, count = self.offsets[name]
        return self.host[copy, off : off + count * W].reshape(count, W)


# ---------------------------------------------------------------------------
# The rounds, the tails and their plain versions
# ---------------------------------------------------------------------------

MAX_GRID_B = 2048  # a round launch's whole grid (blocks x instances) at most: twice MAX_BLOCKS
THREADS = 128  # a round kernel's block (csrc/sumcheck.cuh, kThreads): 32 pairs, four lanes a pair
MAX_BLOCKS = 1024  # a round kernel's blocks an instance at most (kMaxBlocks)
TAIL_PAIRS = 128  # the tail takes over at the first round of at most this many pairs (kTailPairs)
SUMS_ROWS = 7  # the round kernels' sums: 3 x 9 64-bit words, zero between launches, in rows of 8 words

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


def round_blocks(pairs: int, bsz: int) -> int:
    """A round kernel's blocks an instance for ``pairs`` pairs, cut so that
    the grid of ``bsz`` instances stays within MAX_GRID_B blocks."""
    return max(1, min(MAX_BLOCKS, -(-4 * pairs // THREADS), MAX_GRID_B // bsz))


def tail_start(log_n: int) -> int:
    """The first round of at most TAIL_PAIRS pairs (round i has 2^(log_n -
    1 - i)): the tail's first."""
    return max(0, log_n - TAIL_PAIRS.bit_length())


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


def _sc1_emit_plain(q, consts, tor_i, tor_next, pre, coef, state, evals, r_out, r_mont) -> None:
    """A sumcheck-1 round's transcript step: the wire's evaluations ev(t) =
    sum_k K_k(t) q(k) at t = 0..D-1 from this round's coefficients coef (6,
    D, 8: K canonical, then K R) and q(0), q(1), q(2) ((8, 3) Montgomery),
    canonical to evals (D, 8); absorb ser_fr_vec of them, sample r_i; pre
    becomes pre l_i(r_i) and, when tor_next is given, coef the next round's
    K_k(t) = pre c_k(t) l_{i+1}(t) and K R."""
    k = coef[:3].permute(2, 0, 1)  # (8, 3, D)
    ev = _add(_mul(k[:, 0], q[:, 0:1]), _add(_mul(k[:, 1], q[:, 1:2]), _mul(k[:, 2], q[:, 2:3])))
    evals.copy_(ev.t())
    rm = _absorb_sample_plain(state, fsd.ser_fr_vec_words(ev), r_out, r_mont)
    tor, p = _col(tor_i), _col(pre)
    t2 = _mul(tor, rm)  # l_i(r) = 2 tor_i r - tor_i - r + 1
    ell_r = _add(_sub(_sub(_add(t2, t2), tor), rm), _const_col(FR.r_mod, rm.device))
    p = _mul(p, ell_r)
    pre.copy_(p.reshape(pre.shape))
    if tor_next is None:
        return
    c = consts.permute(2, 0, 1)  # (8, 5, D) Montgomery
    ell = _add(_mul(_col(tor_next), c[:, 3]), c[:, 4])
    kn = [_mul(_mul(_mul(p, c[:, m]), ell), _const_col(1, p.device)) for m in range(3)]  # (8, D) each
    kr = [_mul(x, _const_col(FR.r_mod * FR.r_mod % FR.modulus, p.device)) for x in kn]
    coef.copy_(torch.stack(kn + kr).permute(0, 2, 1).reshape(coef.shape))


def _sc2_emit_plain(q, state, evals, r_out, r_mont) -> None:
    """A sumcheck-2 round's transcript step: the three evaluations canonical
    to evals (3, 8), absorbed with their prefix; sample r."""
    ev = _mul(q, _const_col(1, q.device))  # (8, 3) canonical
    evals.copy_(ev.t())
    _absorb_sample_plain(state, fsd.ser_fr_vec_words(ev), r_out, r_mont)


def _sc1_final_plain(az, bz, cz, r_mont, state, vabc, rabc) -> None:
    """Round 4: fold the width-2 tables by the last challenge, write va, vb,
    vc canonical to vabc (3, 8), absorb them (no prefix), sample r_a, r_b,
    r_c on one counter into rabc (3, 8)."""
    r = _col(r_mont)
    abc = torch.cat([az, bz, cz], dim=1)  # (8, 6)
    v = _mul(_add(abc[:, 0::2], _mul(_sub(abc[:, 1::2], abc[:, 0::2]), r)), _const_col(1, r.device))
    vabc.copy_(v.t())
    st = fsd.fs_feed(fsd.as_words(state.reshape(-1)), fsd.limbs_to_words(v).reshape(-1))
    ctr = 0
    for k in range(3):
        rk, ctr = fsd.fs_sample_fr(st, ctr)
        rabc[k].copy_(fsd.as_int32(rk))
    state.copy_(fsd.as_int32(st).reshape(state.shape))


def _sc1_round_one(az, bz, cz, s, fold, consts, tor_i, tor_next, pre, coef, state, evals, r_out, r_mont):
    """One instance's sumcheck-1 round (fold by r_mont when ``fold``,
    evaluate) and its transcript step. Returns the tables entering the next
    round; writes evals, r_out, r_mont, pre, coef and state."""
    q, az, bz, cz = sck.sc1_round(az, bz, cz, s, fold, r_mont, sck.PLAIN)
    _sc1_emit_plain(q, consts, tor_i, tor_next, pre, coef, state, evals, r_out, r_mont)
    return az, bz, cz


def _prod2_round_one(w, z, fold, state, evals, r_out, r_mont):
    """One instance's sumcheck-2 round and its transcript step."""
    q, w, z = sck.prod2_round(w, z, fold, r_mont, sck.PLAIN)
    _sc2_emit_plain(q, state, evals, r_out, r_mont)
    return w, z


def _weights(s_cat: torch.Tensor, pairs0: int):
    """The tail's weight tables, (8, pairs) each, from their concatenation."""
    out, off, pairs = [], 0, pairs0
    while pairs >= 1:
        out.append(s_cat[off : off + W * pairs].view(W, pairs))
        off, pairs = off + W * pairs, pairs // 2
    return out


def _sc1_tail_one(az, bz, cz, s_cat, fold, consts, tor, pre, coef, state, evals, rs, r_mont, vabc, rabc) -> None:
    """One instance's sumcheck-1 tail: the rounds from the tables entering
    the first (width 4 pairs0 when ``fold``, else 2 pairs0) down to one
    pair, then round 4. tor (rounds, 8), coef the first round's (6, D, 8),
    evals (rounds, D, 8), rs (rounds, 8)."""
    pairs0 = _pairs(az, fold)
    weights = _weights(s_cat, pairs0)
    coef = coef.clone()  # the tail keeps the later rounds' coefficients to itself
    for k, s in enumerate(weights):
        nxt = tor[k + 1] if k + 1 < len(weights) else None
        az, bz, cz = _sc1_round_one(az, bz, cz, s, fold or k > 0, consts, tor[k], nxt, pre, coef, state, evals[k],
                                    rs[k], r_mont)
    _sc1_final_plain(az, bz, cz, r_mont, state, vabc, rabc)


def _sc2_tail_one(w, z, fold, state, evals, rs, r_mont) -> None:
    """One instance's sumcheck-2 tail: the rounds down to one pair."""
    for k in range(_pairs(w, fold).bit_length()):
        w, z = _prod2_round_one(w, z, fold or k > 0, state, evals[k], rs[k], r_mont)


def _pairs(table: torch.Tensor, fold: bool) -> int:
    return table.shape[-1] // (4 if fold else 2)


# ---------------------------------------------------------------------------
# The launches: B instances of one circuit each (the single prove is B = 1)
# ---------------------------------------------------------------------------
#
# Tables are (B, 8, n), each instance a contiguous (8, n) table; the weights
# (B, 8, pairs) at any instance stride; every transcript array (B, ...) a
# view of one ``_Buffer`` with a copy an instance, so one stride, ``ist``,
# steps them all. The kernels get instance 0's pointers and the strides. The
# plain versions run the instances one after the other.


def sc1_round_plain(az, bz, cz, s, fold, consts, tor_i, tor_next, pre, coef, state, evals, r_out, r_mont):
    """``sc1_round`` in PyTorch, on each instance."""
    outs = [_sc1_round_one(az[b], bz[b], cz[b], s[b], fold, consts, tor_i[b], tor_next[b], pre[b], coef[b], state[b],
                           evals[b], r_out[b], r_mont[b]) for b in range(az.shape[0])]
    return tuple(torch.stack(t) for t in zip(*outs))


def prod2_round_plain(w, z, fold, state, evals, r_out, r_mont):
    """``prod2_round`` in PyTorch, on each instance."""
    outs = [_prod2_round_one(w[b], z[b], fold, state[b], evals[b], r_out[b], r_mont[b]) for b in range(w.shape[0])]
    return tuple(torch.stack(t) for t in zip(*outs))


def sc1_tail_plain(az, bz, cz, s_cat, fold, consts, tor, pre, coef, state, evals, rs, r_mont, vabc, rabc) -> None:
    """``sc1_tail`` in PyTorch, on each instance."""
    for b in range(az.shape[0]):
        _sc1_tail_one(az[b], bz[b], cz[b], s_cat[b], fold, consts, tor[b], pre[b], coef[b], state[b], evals[b], rs[b],
                      r_mont[b], vabc[b], rabc[b])


def sc2_tail_plain(w, z, fold, state, evals, rs, r_mont) -> None:
    """``sc2_tail`` in PyTorch, on each instance."""
    for b in range(w.shape[0]):
        _sc2_tail_one(w[b], z[b], fold, state[b], evals[b], rs[b], r_mont[b])


def _ist(*arrays) -> int:
    """The one instance stride of the transcript arrays, in words (0 for a
    single instance, whose arrays' strides say nothing)."""
    if arrays[0].shape[0] == 1:
        return 0
    strides = {a.stride(0) for a in arrays}
    if len(strides) != 1:
        raise ValueError(f"the transcript arrays differ in instance stride: {sorted(strides)}")
    return strides.pop()


def _first(x: torch.Tensor) -> torch.Tensor:
    """An array of every instance as the kernels take it: instance 0's
    pointer, the others at their stride. A single instance's (1, ...) view
    is contiguous and goes as it is (no new view: the host's cost a launch
    stays that of the arrays themselves); else instance 0's array."""
    return x if x.is_contiguous() else x[0]


def _batch_tabs(tabs, fold: bool):
    """A round's entering tables, contiguous, and the folded tables' outputs."""
    tabs = [t.contiguous() for t in tabs]
    bsz, pairs = tabs[0].shape[0], _pairs(tabs[0], fold)
    outs = ([torch.empty((bsz, W, 2 * pairs), dtype=torch.int32, device=tabs[0].device) for _ in tabs] if fold
            else tabs)
    return tabs, outs, bsz, pairs


def sc1_round(az, bz, cz, s, fold, consts, tor_i, tor_next, pre, coef, state, evals, r_out, r_mont, ctr, sums):
    """K6 with its transcript step (``sc1_round_kernel``) on CUDA tensors,
    one launch of (``round_blocks``, B) blocks; ``sc1_round_plain`` on CPU
    ones. ctr (the ticket counter) and sums (SUMS_ROWS rows) are zero
    between launches."""
    if az.device.type == "cpu":
        return sc1_round_plain(az, bz, cz, s, fold, consts, tor_i, tor_next, pre, coef, state, evals, r_out, r_mont)
    tabs, outs, bsz, pairs = _batch_tabs((az, bz, cz), fold)
    per = [tor_i, tor_next, pre, coef, state, evals, r_out, r_mont, ctr]
    kernels.call("sc1_round", [*tabs, _first(s), consts, *map(_first, per), *outs, _first(sums)],
                 [pairs, int(fold), round_blocks(pairs, bsz), consts.shape[1], bsz, s.stride(0), _ist(*per, sums)],
                 key=(pairs, int(fold), bsz))
    return tuple(outs)


def prod2_round(w, z, fold, state, evals, r_out, r_mont, ctr, sums):
    """K7 with its transcript step (``prod2_round_kernel``) on CUDA tensors;
    ``prod2_round_plain`` on CPU ones."""
    if w.device.type == "cpu":
        return prod2_round_plain(w, z, fold, state, evals, r_out, r_mont)
    tabs, outs, bsz, pairs = _batch_tabs((w, z), fold)
    per = [state, evals, r_out, r_mont, ctr]
    kernels.call("prod2_round", [*tabs, *map(_first, per), *outs, _first(sums)],
                 [pairs, int(fold), round_blocks(pairs, bsz), bsz, _ist(*per, sums)], key=(pairs, int(fold), bsz))
    return tuple(outs)


def sc1_tail(az, bz, cz, s_cat, fold, consts, tor, pre, coef, state, evals, rs, r_mont, vabc, rabc) -> None:
    """The tail of sumcheck 1 with round 4, a block an instance
    (``sc1_tail_kernel``), on CUDA tensors; ``sc1_tail_plain`` on CPU ones.
    s_cat: (B, L), each instance's weight tables one after the other."""
    if az.device.type == "cpu":
        return sc1_tail_plain(az, bz, cz, s_cat, fold, consts, tor, pre, coef, state, evals, rs, r_mont, vabc, rabc)
    pairs0, bsz = _pairs(az, fold), az.shape[0]
    per = [tor, pre, coef, state, evals, rs, r_mont, vabc, rabc]
    kernels.call("sc1_tail", [az.contiguous(), bz.contiguous(), cz.contiguous(), _first(s_cat), consts,
                              *map(_first, per)],
                 [pairs0, int(fold), pairs0.bit_length(), consts.shape[1], bsz, s_cat.stride(0), _ist(*per)],
                 key=(pairs0, int(fold), bsz))


def sc2_tail(w, z, fold, state, evals, rs, r_mont) -> None:
    """The tail of sumcheck 2, a block an instance (``sc2_tail_kernel``), on
    CUDA tensors; ``sc2_tail_plain`` on CPU ones."""
    if w.device.type == "cpu":
        return sc2_tail_plain(w, z, fold, state, evals, rs, r_mont)
    pairs0, bsz = _pairs(w, fold), w.shape[0]
    per = [state, evals, rs, r_mont]
    kernels.call("sc2_tail", [w.contiguous(), z.contiguous(), *map(_first, per)],
                 [pairs0, int(fold), pairs0.bit_length(), bsz, _ist(*per)], key=(pairs0, int(fold), bsz))


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


def sc1_phase(az, bz, cz, suffix, tors: List[List[int]], states: List[bytes]) -> List[Sc1Result]:
    """Sumcheck 1 and prover round 4 with the transcript on the device, for
    B instances of one circuit: each round one ``sc1_round`` launch and the
    tail one ``sc1_tail``, whatever B is; one upload starts the phase and one
    copy ends it.

    az, bz, cz: (B, 8, n) Montgomery tables; suffix: the eq suffix tables
    of each instance's tor, (B, 8, 2^(log_n - j)) each
    (``mle.eq_suffix_tables_mont``); tors: B lists of the log_n challenges
    as ints; states: B chain states after the third prover message.
    Returns each instance's result."""
    bsz, log_n = az.shape[0], len(tors[0])
    d, i0 = log_n + 3, tail_start(log_n)
    buf = _sc1_buffer(tors, states)
    buf.upload(az.device)
    consts = emit_consts(log_n + 2, az.device)
    evals, rs, tor_m = buf.views("evals").view(bsz, log_n, d, W), buf.views("rs"), buf.views("tor")
    pre, st, r_mont = buf.views("pre"), buf.views("state"), buf.views("r_mont")
    coef, ctr, sums = buf.views("coef").view(bsz, 6, d, W), buf.views("ctr"), buf.views("sums")
    tor_i, evals_i, rs_i = tor_m.unbind(1), evals.unbind(1), rs.unbind(1)  # each round's views, taken at once
    for i in range(i0):  # round 0 takes no fold: r_mont is not read
        az, bz, cz = sc1_round(az, bz, cz, suffix[i + 1], i > 0, consts, tor_i[i], tor_i[i + 1], pre, coef, st,
                               evals_i[i], rs_i[i], r_mont, ctr, sums)
    s_cat = torch.cat([suffix[j].reshape(bsz, -1) for j in range(i0 + 1, log_n + 1)], dim=1)
    sc1_tail(az, bz, cz, s_cat, i0 > 0, consts, tor_m[:, i0:], pre, coef, st, evals[:, i0:], rs[:, i0:], r_mont,
             buf.views("vabc"), buf.views("rabc"))
    buf.fetch()
    return [_sc1_result(buf, log_n, b) for b in range(bsz)]


def _sc1_buffer(tors: List[List[int]], states: List[bytes]) -> _Buffer:
    """Sumcheck 1's buffer, a copy an instance: its chain state, pre = 1,
    tor and round 0's coefficients."""
    log_n = len(tors[0])
    d = log_n + 3
    buf = _Buffer([("evals", log_n * d), ("rs", log_n), ("vabc", 3), ("rabc", 3), ("state", 1),
                   ("pre", 1), ("r_mont", 1), ("tor", log_n), ("ctr", 1), ("sums", SUMS_ROWS),
                   ("coef", 6 * d)], len(tors))
    buf.set("state", _state_words(states))
    buf.set("pre", _words([FR.r_mod]))  # 1 in Montgomery form
    buf.set("tor", np.stack([_words([t * FR.r_mod % FR.modulus for t in tor]) for tor in tors]))
    buf.set("coef", np.stack([_words(first_coef(tor[0], d - 1)) for tor in tors]))
    return buf


def _sc1_result(buf: _Buffer, log_n: int, b: int) -> Sc1Result:
    d = log_n + 3
    ev = _ints(buf.get("evals", b))
    return Sc1Result(evals=[ev[i * d : (i + 1) * d] for i in range(log_n)], rs=_ints(buf.get("rs", b)),
                     vabc=_ints(buf.get("vabc", b)), rabc=_ints(buf.get("rabc", b)),
                     state=fsd.words_to_state(buf.get("state", b)))


def _state_words(states: List[bytes]) -> np.ndarray:
    return np.stack([fsd.as_int32(fsd.state_to_words(s)).numpy() for s in states])


def sc2_phase(w, z, states: List[bytes]) -> List[Sc2Result]:
    """Sumcheck 2 with the transcript on the device, for B instances: w, z
    (B, 8, n) Montgomery tables, states the B chain states after the fifth
    prover message; each round one ``prod2_round`` launch and the tail one
    ``sc2_tail``. Returns each instance's result."""
    bsz, log_n = w.shape[0], w.shape[-1].bit_length() - 1
    i0 = tail_start(log_n)
    buf = _Buffer([("evals", 3 * log_n), ("rs", log_n), ("state", 1), ("r_mont", 1), ("ctr", 1),
                   ("sums", SUMS_ROWS)], bsz)
    buf.set("state", _state_words(states))
    buf.upload(w.device)
    evals, rs = buf.views("evals").view(bsz, log_n, 3, W), buf.views("rs")
    st, r_mont, ctr, sums = buf.views("state"), buf.views("r_mont"), buf.views("ctr"), buf.views("sums")
    evals_i, rs_i = evals.unbind(1), rs.unbind(1)
    for i in range(i0):
        w, z = prod2_round(w, z, i > 0, st, evals_i[i], rs_i[i], r_mont, ctr, sums)
    sc2_tail(w, z, i0 > 0, st, evals[:, i0:], rs[:, i0:], r_mont)
    buf.fetch()
    return [_sc2_result(buf, log_n, b) for b in range(bsz)]


def _sc2_result(buf: _Buffer, log_n: int, b: int) -> Sc2Result:
    ev = _ints(buf.get("evals", b))
    return Sc2Result(evals=[ev[3 * i : 3 * (i + 1)] for i in range(log_n)], rs=_ints(buf.get("rs", b)),
                     state=fsd.words_to_state(buf.get("state", b)))


# prove_many calls sumcheck 2 by this name: the benchmark's fault tests
# (portbench/tests/test_portbench_harness.py) patch it apart from the
# single prove's ``sc2_phase``
sc2_phase_b = sc2_phase
